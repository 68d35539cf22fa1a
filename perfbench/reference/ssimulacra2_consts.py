"""SSIMULACRA2 v2.1 constants for the benchmark's plain reference.

A frozen copy of the values in the program's ops/ssimulacra2_consts.py
(libjxl's tools/ssimulacra2.cc, v2.1), taken once so that the reference
imports nothing of the program. perfbench/tests pin the copy.

Feature ordering of WEIGHTS (upstream `Msssim::Score()`):
  for c in (X, Y, B): for scale in 0..5: for n in (1-norm, 4-norm):
      weight[i++] * ssim[c, scale, n]
      weight[i++] * artifact[c, scale, n]
      weight[i++] * detail_loss[c, scale, n]
"""

from __future__ import annotations

import numpy as np

# libjxl opsin absorbance (linear sRGB -> LMS mix), exact upstream values.
OPSIN_MATRIX = np.array(
    [
        [0.30, 0.622, 0.078],
        [0.23, 0.692, 0.078],
        [0.24342268924547819, 0.20476744424496821, 0.55180986650955360],
    ],
    dtype=np.float64,
)
OPSIN_BIAS = 0.0037930732552754493

# v2.1 "make positive XYB" affine shifts: b=(b-y)+0.55, x=x*14+0.42, y=y+0.01
XYB_B_OFFSET = 0.55
XYB_X_SCALE = 14.0
XYB_X_OFFSET = 0.42
XYB_Y_OFFSET = 0.01

NUM_SCALES = 6
SSIM_C2 = 0.0009
GAUSSIAN_SIGMA = 1.5

# Final score mapping: ssim = dot(weights, features); then
#   ssim *= SCORE_SCALE
#   ssim = P1*ssim - P2*ssim^2 + P3*ssim^3
#   score = 100 - 10 * ssim^POW   (ssim > 0, else 100)
SCORE_SCALE = 0.9562382616834844
SCORE_P3 = 6.248496625763138e-05
SCORE_P2 = 0.020884521182843837
SCORE_P1 = 2.326765642916932
SCORE_POW = 0.6276336467831387

# Per-channel weight blocks, each shape (scales=6, n=2, metric=3) flattened
# in the order documented above: [ssim, artifact, detail] per (scale, n).
_X_BLOCK = [
    # scale 0
    0.0, 0.0007376606707406586, 0.0,
    0.0, 0.0007793481682867309, 0.0,
    # scale 1
    0.0, 0.0004371155730107379, 0.0,
    1.1041726426657346, 0.00066284834129271, 0.00015231632783718752,
    # scale 2
    0.0, 0.0016406437456599754, 0.0,
    1.8422455520539298, 11.441172603757666, 0.0,
    # scale 3
    0.0007989109436015163, 0.000176816438078653, 0.0,
    1.8787594979546387, 10.94906990605142, 0.0007989109436015163,
    # scale 4
    0.0007289346991508072, 0.9677937080626833, 0.0,
    0.0007289346991508072, 0.9981766977854967, 0.00031949755934435053,
    # scale 5
    0.0004550992113792063, 0.0, 0.0,
    0.0013648766163243398, 0.0, 0.0,
]

_Y_BLOCK = [
    # scale 0
    7.466890328078848, 0.0, 17.445833984131262,
    0.0006235601634041466, 0.0, 0.0,
    # scale 1
    6.683678146179332, 0.00037724407979611296, 1.027889937768264,
    225.20515300849274, 0.0, 0.0,
    # scale 2
    19.213664498325443, 0.0011401524586618361, 0.001237755635509985,
    176.39317598450694, 0.0, 0.0,
    # scale 3
    24.43300999870476, 0.28520802612117757, 0.0004485436923833408,
    0.0, 0.0, 0.0,
    # scale 4
    34.77906344483772, 44.835625328877896, 0.0,
    0.0006728221899892144, 0.0, 0.0,
    # scale 5
    10.101925365917896, 0.0, 0.0,
    0.0004776023846810402, 0.0, 0.0,
]

_B_BLOCK = [
    # scale 0
    8.016344115322605, 0.0, 0.0,
    0.0017290828234722833, 0.0, 0.0,
    # scale 1
    0.0004643437341017302, 0.0, 0.0,
    0.0, 0.0, 0.0,
    # scale 2
    0.0, 0.0, 0.0,
    0.0, 0.0, 0.0,
    # scale 3
    0.0, 0.0, 0.0,
    0.0, 0.0, 0.0,
    # scale 4
    0.0005109589375497164, 0.0, 0.0,
    0.0, 0.0, 0.0,
    # scale 5
    0.0, 0.0, 0.0,
    0.0, 0.0, 0.0,
]

WEIGHTS = np.array(_X_BLOCK + _Y_BLOCK + _B_BLOCK, dtype=np.float64)
assert WEIGHTS.shape == (108,)
