from repro_torch.coding import gf256, layout, rs
from repro_torch.coding import codec as codec_module
from repro_torch.coding.codec import Codec, get_codec
from repro_torch.coding.layout import SharedKeyLayout, layout_for_file
from repro_torch.coding.rs import MDSCode

__all__ = [
    "gf256",
    "rs",
    "layout",
    "codec_module",
    "Codec",
    "get_codec",
    "MDSCode",
    "SharedKeyLayout",
    "layout_for_file",
]
