// K3's float64 build: k3_cone.cu compiled for double operands alone, in a
// translation unit of its own, so that nvcc builds it beside the float
// build (their instantiations took one nvcc 76-87 s together).
#define OMC_K3_F64
#include "k3_cone.cu"
