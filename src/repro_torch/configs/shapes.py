"""The four input shapes and the per-(arch × shape) policy; the port's own
copy of ``repro/configs/shapes.py`` (pure data, no JAX).

``decode_32k`` / ``long_500k`` lower ``serve_step`` (ONE token with a KV
cache of ``seq_len``), not ``train_step``. long_500k requires
sub-quadratic attention state: SSM/hybrid/local-attention archs run
natively; pure full-attention archs run via the sliding-window variant
(``swa_override``), per the assignment rules (see DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# Window used when a pure full-attention arch runs long_500k.
LONG_CONTEXT_SWA_WINDOW = 8_192


def get_shape(name: str) -> InputShape:
    try:
        return SHAPES[name]
    except KeyError:
        raise ValueError(f"unknown shape '{name}'; have {sorted(SHAPES)}") from None


def needs_swa_override(cfg, shape: InputShape) -> bool:
    """True when the arch needs the sliding-window variant for this shape:
    *pure* full-attention stacks (every mixer "A"/"X") on the 500k decode
    shape. Archs with native sub-quadratic structure — SSM ("M") or
    local-attention ("L") layers (mamba2, jamba, gemma3) — run long_500k
    natively: their occasional global layers decode in O(S) against a
    sharded KV cache (DESIGN.md §4)."""
    return shape.name == "long_500k" and all(
        m in ("A", "X") for m in cfg.mixer_pattern
    )


def apply_shape_policy(cfg, shape: InputShape):
    """Return the (possibly SWA-overridden) config used for this shape."""
    if needs_swa_override(cfg, shape):
        pattern = tuple("L" if m == "A" else m for m in cfg.mixer_pattern)
        return cfg.replace(
            mixer_pattern=pattern, sliding_window=LONG_CONTEXT_SWA_WINDOW
        )
    return cfg
