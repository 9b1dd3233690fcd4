// Per-field constants in __constant__ memory, from the header that
// vdf_tpu_torch/_build.py generates out of fields/params.py.  Indexed by
// the kernels' field argument: 0 = Fp, 1 = Fq.  The anonymous namespace
// gives each translation unit its own copy, so minroot.cu and msm.cu link
// into one library without clashing symbols.
#pragma once

#include "curve.cuh"
#include "field.cuh"
#include "vdf_consts.h"  // generated at build

namespace vdf {
namespace {

__constant__ FieldConsts FIELD_CONSTS[2] = VDF_FIELD_CONSTS_INIT;
__constant__ CurveConsts CURVE_CONSTS[2] = VDF_CURVE_CONSTS_INIT;

}  // namespace
}  // namespace vdf
