from repro_torch.kernels.gf2mm.gf2mm import gf2_matmul, gf2_rs_matmul_bytes
from repro_torch.kernels.gf2mm.ops import decode_blob, encode_blob, rs_decode, rs_encode

__all__ = [
    "gf2_matmul",
    "gf2_rs_matmul_bytes",
    "rs_encode",
    "rs_decode",
    "encode_blob",
    "decode_blob",
]
