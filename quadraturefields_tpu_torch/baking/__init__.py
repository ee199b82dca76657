from .compression import FeatureCompression
from .uvatlas import build_uv_atlas, rasterize_v_image

__all__ = ["FeatureCompression", "build_uv_atlas", "rasterize_v_image"]
