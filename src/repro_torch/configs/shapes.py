"""The reference's input shapes (one set, shared by all 10 LM-family
archs; the reference's ``configs/shapes.py``).

  train_4k     seq 4096  x global_batch 256   -> train_step
  prefill_32k  seq 32768 x global_batch 32    -> prefill (forward, no grad)
  decode_32k   KV cache 32768, global_batch 128 -> serve_step (1 new token)
  long_500k    KV cache 524288, global_batch 1  -> serve_step; sub-quadratic
               archs only (hybrid/ssm): full-attention archs skip
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str                  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs able to run 524288-token decode (recurrent state / windowed cache)
SUBQUADRATIC_ARCHS = {"recurrentgemma-9b", "rwkv6-3b"}


def applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC_ARCHS
    return True


def cells(archs) -> list[tuple[str, str]]:
    """All (arch x shape) cells, with the documented skips applied."""
    out = []
    for a in archs:
        for s in SHAPES:
            if applicable(a, s):
                out.append((a, s))
    return out
