// Pieces shared by the panel kernels (panel_step.cu, panel_gram.cu,
// panel_apply.cu, panel_deflate.cu).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kMaxPanel = 64;      // widest panel (MAX_PANEL in kernel.py)

}  // namespace repro
