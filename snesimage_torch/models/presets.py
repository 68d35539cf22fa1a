"""Target-hardware presets ("model families").

The reference leaves palette geometry to raw flags and documents the
useful combinations in prose ("values of 3, 7 and 15 are most likely to
be useful", README.md:17-19; SNES modes discussion in TODO.md:14-18).
These presets name the actual SNES/NES video-mode constraints so users
pick hardware targets instead of numbers. Each preset is a partial
QuantConfig; CLI flags still override individual fields.
"""

from __future__ import annotations

from snesimage_torch.config import QuantConfig

# name -> (description, config fields)
PRESETS: dict[str, tuple[str, dict]] = {
    "snes-mode1-bg12": (
        "SNES Mode 1 BG1/BG2: 8 subpalettes x 15 colors (4bpp)",
        dict(subpalette_count=8, subpalette_size=15),
    ),
    "snes-mode1-bg3": (
        "SNES Mode 1 BG3: 8 subpalettes x 3 colors (2bpp)",
        dict(subpalette_count=8, subpalette_size=3),
    ),
    "snes-mode0": (
        "SNES Mode 0: 8 subpalettes x 3 colors (2bpp, per-BG palettes)",
        dict(subpalette_count=8, subpalette_size=3),
    ),
    "snes-sprites": (
        "SNES OBJ/sprites: 8 subpalettes x 15 colors (upper CGRAM half)",
        dict(subpalette_count=8, subpalette_size=15),
    ),
    "snes-single": (
        "Single 15-color palette (the reference's -c 1 -s 15)",
        dict(subpalette_count=1, subpalette_size=15),
    ),
    "nes-compat": (
        "NES-lookalike output on SNES: 4 subpalettes x 3 NES-snapped "
        "colors (README.md:30-37)",
        dict(subpalette_count=4, subpalette_size=3, nes=True),
    ),
    "gb-like": (
        "Game-Boy-ish: 1 subpalette x 3 colors + transparent",
        dict(subpalette_count=1, subpalette_size=3),
    ),
}


def get_preset(name: str, **overrides) -> QuantConfig:
    """Build a QuantConfig from a preset name plus field overrides."""
    if name not in PRESETS:
        raise ValueError(
            f"Unknown preset '{name}'. Available: {', '.join(sorted(PRESETS))}"
        )
    _, fields = PRESETS[name]
    merged = {**fields, **overrides}
    return QuantConfig(**merged)


def describe_presets() -> str:
    width = max(len(n) for n in PRESETS)
    return "\n".join(f"{n:<{width}}  {desc}" for n, (desc, _) in sorted(PRESETS.items()))


def preset_fields(name: str) -> dict:
    """The raw field dict of a preset (for CLI merging)."""
    if name not in PRESETS:
        raise ValueError(
            f"Unknown preset '{name}'. Available: {', '.join(sorted(PRESETS))}"
        )
    return dict(PRESETS[name][1])
