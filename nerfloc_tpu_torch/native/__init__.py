"""Host-side native engines (counterpart of nerfloc_tpu/native/): TSDF
fusion, integrated on the card by a hand-written CUDA kernel and on the
CPU by its host copy (native/tsdf.py)."""
from .tsdf import LAUNCHES, TSDFVolume, integrate_frame

__all__ = ["LAUNCHES", "TSDFVolume", "integrate_frame"]
