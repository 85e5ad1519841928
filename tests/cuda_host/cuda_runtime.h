// Stands in for the CUDA runtime header when a kernel source is compiled as
// host C++: warp_emu.h, unless the including file chose block_emu.h first.
#pragma once
#ifndef CUDA_HOST_BLOCK_EMU
#include "warp_emu.h"
#endif
