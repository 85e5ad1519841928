// Stands in for the CUDA runtime header when a kernel source is compiled as
// host C++ (see warp_emu.h).
#pragma once
#include "warp_emu.h"
