from snesimage_torch.models.presets import PRESETS, get_preset

__all__ = ["PRESETS", "get_preset"]
