"""Published per-cell results transcribed from the paper (Tables II–IX).

These are the calibration targets for the replay backend and the
claims-validation benchmarks.  Accuracy entries are
(ordered_pct, any_order_pct, compiled); `compiled=False` reproduces the (NC)
cells.  Stages are the in-context sample sizes {20, 50, 100}.
"""
from __future__ import annotations

MODELS = [
    "R1:70b", "Gem3:12b", "Gem3:27b", "OSS:120b", "OSS:20b", "Lla3.3:70b",
    "Lla4:16x17b", "Mist-N:12b", "Nemo:70b", "Qw3:235b", "Qw3:32b",
]

MODEL_FULL_NAMES = {
    "R1:70b": "deepseek-r1:70b", "Gem3:12b": "gemma3:12b",
    "Gem3:27b": "gemma3:27b", "OSS:120b": "gpt-oss:120b",
    "OSS:20b": "gpt-oss:20b", "Lla3.3:70b": "llama3.3:70b",
    "Lla4:16x17b": "llama4:16x17b", "Mist-N:12b": "mistral-nemo:12b",
    "Nemo:70b": "nemotron:70b", "Qw3:235b": "qwen3:235b", "Qw3:32b": "qwen3:32b",
}

STAGES = (20, 50, 100)

_O = True   # compiled ok
_N = False  # (NC)

# domain -> model -> ((ord20, any20, ok), (ord50, any50, ok), (ord100, any100, ok))
ACCURACY: dict[str, dict[str, tuple]] = {
    # ------------------------------------------------ Table II: 2D Triangular
    "tri2d": {
        "R1:70b":      ((100, 100, _O), (100, 100, _O), (100, 100, _O)),
        "Gem3:12b":    ((0, 0, _O), (0, 1.27, _O), (0, 1.83, _O)),
        "Gem3:27b":    ((0, 50.05, _O), (0, 1.27, _O), (0, 50.05, _O)),
        "OSS:120b":    ((100, 100, _O), (100, 100, _O), (100, 100, _O)),
        "OSS:20b":     ((0, 0.71, _O), (100, 100, _O), (100, 100, _O)),
        "Lla3.3:70b":  ((100, 100, _O), (0, 0, _O), (0, 0.14, _O)),
        "Lla4:16x17b": ((0, 0.71, _O), (0, 1.27, _O), (0, 0.01, _O)),
        "Mist-N:12b":  ((0, 0.71, _O), (0, 1.27, _O), (0, 1.69, _O)),
        "Nemo:70b":    ((0, 0, _O), (0, 0.14, _O), (100, 100, _O)),
        "Qw3:235b":    ((100, 100, _O), (0.14, 0.14, _O), (0, 0, _N)),
        "Qw3:32b":     ((100, 100, _O), (100, 100, _O), (100, 100, _O)),
    },
    # ------------------------------------------- Table III: Sierpinski Gasket
    "gasket2d": {
        "R1:70b":      ((0, 8.10, _O), (4.57, 21.30, _O), (0, 1.52, _O)),
        "Gem3:12b":    ((0, 1.03, _O), (0, 1.55, _O), (0, 0.69, _O)),
        "Gem3:27b":    ((0, 1.03, _O), (0, 5.22, _O), (0, 5.22, _O)),
        "OSS:120b":    ((0, 8.10, _O), (100, 100, _O), (100, 100, _O)),
        "OSS:20b":     ((100, 100, _O), (0, 0, _N), (100, 100, _O)),
        "Lla3.3:70b":  ((0, 7.96, _O), (0, 1.17, _O), (0, 3.19, _O)),
        "Lla4:16x17b": ((0, 0.34, _O), (0, 0, _O), (0, 0.01, _O)),
        "Mist-N:12b":  ((0, 0, _O), (0, 3.09, _O), (0, 0.01, _O)),
        "Nemo:70b":    ((0, 8.10, _O), (0, 8.10, _O), (0, 8.10, _O)),
        "Qw3:235b":    ((0, 0, _N), (0, 0, _O), (0, 0, _N)),
        "Qw3:32b":     ((0, 8.10, _O), (0, 0.01, _O), (0, 0, _N)),
    },
    # -------------------------------------------- Table IV: Sierpinski Carpet
    "carpet2d": {
        "R1:70b":      ((0, 0.58, _O), (0, 0, _O), (0, 37.08, _O)),
        "Gem3:12b":    ((0, 0.58, _O), (0, 0.39, _O), (0, 0.58, _O)),
        "Gem3:27b":    ((0, 0.39, _O), (0, 0.20, _N), (0, 1.04, _O)),
        "OSS:120b":    ((0, 0.58, _O), (0.01, 1.04, _O), (100, 100, _O)),
        "OSS:20b":     ((0, 0.58, _O), (0, 0, _N), (0, 0.58, _O)),
        "Lla3.3:70b":  ((0, 0.39, _O), (0, 0.39, _O), (0, 0.46, _O)),
        "Lla4:16x17b": ((0, 0.58, _O), (0, 1.04, _O), (0, 1.56, _O)),
        "Mist-N:12b":  ((0, 0.39, _O), (0, 1.04, _O), (0, 1.30, _O)),
        "Nemo:70b":    ((0, 0, _O), (0, 0.58, _O), (0, 0.10, _O)),
        "Qw3:235b":    ((100, 100, _O), (100, 100, _O), (0, 0, _N)),
        "Qw3:32b":     ((0, 0, _O), (0, 0.03, _O), (0, 0.58, _O)),
    },
    # ------------------------------- Table V: 3D Triangular (tetra / pyramid)
    "pyramid3d": {
        "R1:70b":      ((0.11, 82.70, _O), (100, 100, _O), (0, 0, _O)),
        "Gem3:12b":    ((0, 0.02, _O), (0, 0.02, _O), (0, 0.02, _O)),
        "Gem3:27b":    ((0, 0, _O), (0, 0, _O), (0, 17.17, _O)),
        "OSS:120b":    ((100, 100, _O), (100, 100, _O), (100, 100, _O)),
        "OSS:20b":     ((0, 0, _N), (100, 100, _O), (100, 100, _O)),
        "Lla3.3:70b":  ((0, 0, _O), (0, 17.16, _O), (0, 0, _O)),
        "Lla4:16x17b": ((0, 0, _O), (0, 0, _O), (0, 0, _O)),
        "Mist-N:12b":  ((0, 0.05, _O), (0, 0.18, _O), (0, 0, _O)),
        "Nemo:70b":    ((0, 0.14, _O), (0, 0, _O), (0, 0, _O)),
        "Qw3:235b":    ((100, 100, _O), (0, 16.96, _O), (100, 100, _O)),
        "Qw3:32b":     ((100, 100, _O), (100, 100, _O), (100, 100, _O)),
    },
    # ------------------------------------- Table VI: 3D Sierpinski Pyramid
    "sierpinski3d": {
        "R1:70b":      ((0, 0, _O), (0, 0, _O), (0, 0, _O)),
        "Gem3:12b":    ((0, 0.20, _O), (0, 0.10, _O), (0, 0, _N)),
        "Gem3:27b":    ((0, 0.31, _O), (0, 0.18, _O), (0, 0, _O)),
        "OSS:120b":    ((100, 100, _O), (0, 1.23, _O), (100, 100, _O)),
        "OSS:20b":     ((0, 0, _N), (0, 0, _N), (0, 0, _N)),
        "Lla3.3:70b":  ((0, 0.59, _N), (0, 0, _N), (0, 0.28, _O)),
        "Lla4:16x17b": ((0, 0.01, _O), (0, 1.87, _O), (0, 0, _N)),
        "Mist-N:12b":  ((0, 0.49, _O), (0, 0, _O), (0, 0, _O)),
        "Nemo:70b":    ((0, 0, _N), (0, 0, _N), (0, 2.52, _O)),
        "Qw3:235b":    ((0, 0, _N), (0, 0, _N), (0, 0, _N)),
        "Qw3:32b":     ((0, 0.01, _O), (0, 0.52, _O), (0, 0, _N)),
    },
    # ------------------------------------------ Table VII: 3D Menger Sponge
    "menger3d": {
        "R1:70b":      ((0, 0.05, _O), (0, 0, _N), (0, 0.05, _O)),
        "Gem3:12b":    ((0, 0.05, _O), (0, 0.36, _O), (0, 0.05, _O)),
        "Gem3:27b":    ((0, 0.05, _O), (0, 0.05, _O), (0, 0.05, _O)),
        "OSS:120b":    ((0, 0, _O), (0.01, 0.16, _O), (0.01, 0.36, _O)),
        "OSS:20b":     ((0, 0, _O), (0.01, 0.16, _O), (0, 0, _O)),
        "Lla3.3:70b":  ((0, 0.05, _O), (0, 0.04, _O), (0, 0.36, _O)),
        "Lla4:16x17b": ((0, 0.06, _O), (0, 0.16, _O), (0, 0.16, _O)),
        "Mist-N:12b":  ((0, 0.03, _O), (0, 0, _O), (0, 0.11, _O)),
        "Nemo:70b":    ((0, 0, _N), (0, 0.05, _O), (0, 0.01, _O)),
        "Qw3:235b":    ((0, 0.05, _O), (0.01, 0.16, _O), (0, 0, _N)),
        "Qw3:32b":     ((0, 0, _O), (0, 0.04, _O), (0, 0.14, _O)),
    },
}

# (domain, model, stage) -> logic class emitted, for the 100%-ordered cells
# whose implementation style the paper identifies in Tables VIII/IX.
LOGIC_CLASS_OVERRIDES: dict[tuple[str, str, int], str] = {
    ("tri2d", "R1:70b", 100): "sqrt_loop",
    ("tri2d", "OSS:20b", 50): "approx_if",
    ("tri2d", "OSS:20b", 100): "approx_if",
    ("tri2d", "Qw3:32b", 50): "binsearch",
    ("pyramid3d", "R1:70b", 50): "cbrt_loop",
    ("pyramid3d", "Qw3:32b", 20): "cbrt_loop",
    ("pyramid3d", "Qw3:32b", 50): "cbrt_loop",
    ("pyramid3d", "Qw3:32b", 100): "cbrt_loop",
    ("pyramid3d", "OSS:120b", 100): "binsearch",
    ("pyramid3d", "Qw3:235b", 20): "binsearch",
    ("pyramid3d", "OSS:120b", 50): "binsearch_linear",
    ("pyramid3d", "OSS:120b", 20): "linear",
}

# --------------------------------------------------------------------------
# Table VIII — dense geometries, block-level deployment (N = 500e6, A100)
# time in ms, energy in J.
# --------------------------------------------------------------------------
TABLE_VIII = {
    "tri2d": {
        "bounding_box": dict(time_ms=747.45, total_blocks=3_912_484,
                             wasted=1_959_359, energy_j=83.27, logic="if_O1"),
        "paper": dict(time_ms=1.46, total_blocks=1_953_125, wasted=0,
                      energy_j=0.44, logic="analytical"),
        "R1:70b@20": dict(time_ms=1.46, energy_j=0.45, logic="analytical"),
        "R1:70b@50": dict(time_ms=1.46, energy_j=0.45, logic="analytical"),
        "OSS:120b@all": dict(time_ms=1.46, energy_j=0.45, logic="analytical"),
        "Lla3.3:70b@20": dict(time_ms=1.46, energy_j=0.45, logic="analytical"),
        "R1:70b@100": dict(time_ms=1.97, energy_j=0.70, logic="sqrt_loop"),
        "OSS:20b@50": dict(time_ms=1.51, energy_j=0.51, logic="approx_if"),
        "OSS:20b@100": dict(time_ms=1.51, energy_j=0.51, logic="approx_if"),
        "Qw3:32b@50": dict(time_ms=14.86, energy_j=3.21, logic="binsearch"),
    },
    "pyramid3d": {
        "bounding_box": dict(time_ms=2530.65, total_blocks=12_008_989,
                             wasted=10_055_864, energy_j=282.67, logic="if_O1"),
        "paper": dict(time_ms=3.84, total_blocks=1_953_125, wasted=0,
                      energy_j=0.92, logic="analytical"),
        "R1:70b@50": dict(time_ms=6.21, energy_j=1.44, logic="cbrt_loop"),
        "Qw3:32b@all": dict(time_ms=6.21, energy_j=1.44, logic="cbrt_loop"),
        "OSS:120b@100": dict(time_ms=29.31, energy_j=5.99, logic="binsearch"),
        "Qw3:235b@20": dict(time_ms=29.31, energy_j=5.99, logic="binsearch"),
        "OSS:120b@50": dict(time_ms=51.57, energy_j=9.12, logic="binsearch_linear"),
        "OSS:120b@20": dict(time_ms=117.03, energy_j=22.25, logic="linear"),
    },
}

# --------------------------------------------------------------------------
# Table IX — fractal geometries, block-level deployment (N = 500e6, A100)
# --------------------------------------------------------------------------
TABLE_IX = {
    "gasket2d": {
        "bounding_box": dict(time_ms=65.78, total_blocks=88_736_400,
                             wasted=86_783_275, energy_j=6.73, logic="if_O1"),
        "paper": dict(time_ms=8.62, total_blocks=1_953_125, wasted=0,
                      energy_j=1.39, logic="bitwise"),
        "OSS:120b@20": dict(time_ms=8.62, energy_j=1.39, logic="bitwise"),
    },
    "sierpinski3d": {
        "bounding_box": dict(time_ms=15_949.00, total_blocks=8_000_000_000,
                             wasted=7_998_046_875, energy_j=1591.71,
                             logic="if_O1", projected=True),
        "paper": dict(time_ms=3.30, total_blocks=1_953_125, wasted=0,
                      energy_j=0.55, logic="bitwise"),
        "R1:70b@100": dict(time_ms=3.30, energy_j=0.56, logic="bitwise"),
    },
}

# Headline claims (abstract / Sec. V.C)
CLAIM_SPEEDUP = 4833.0          # 3D Sierpinski: 15949 ms / 3.30 ms
CLAIM_ENERGY_REDUCTION = 2890.0  # 1591.71 J / 0.55 J
