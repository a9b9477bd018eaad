"""Cone projections, the sign-schedule PSD projection and ridge steps."""
