"""Scene I/O: VIDI3D JSON and USDA scene files, raw volumes, transfer
functions, colormaps and images (the port's own copies of
`ovr_tpu.io`'s parsers; `create_scene(path, device=...)` loads a scene
onto the card unless the caller passes device="cpu")."""

from ovr_tpu_torch.io.colormaps import available_colormaps, create_colormap
from ovr_tpu_torch.io.image import load_exr, save_exr, save_image
from ovr_tpu_torch.io.raw import load_raw_volume
from ovr_tpu_torch.io.tfn import (TransferFunctionData, load_tfn_file,
                                  load_tfn_json, save_tfn_json)
from ovr_tpu_torch.io.vidi3d import create_scene

__all__ = ["available_colormaps", "create_colormap", "load_exr", "save_exr",
           "save_image", "load_raw_volume", "TransferFunctionData",
           "load_tfn_file", "load_tfn_json", "save_tfn_json", "create_scene"]
