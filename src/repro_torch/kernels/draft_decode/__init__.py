"""Batch-invariant draft-transformer decode kernels: CUDA ``csrc/draft_decode.cu``,
their wrappers and ``DraftDecoder`` (``ops``) and plain versions (``ref``)."""

from repro_torch.kernels.draft_decode.ops import (
    DraftDecoder, attn_cached, draft_decode_supported, head, post_attn, qkv_rope,
)
from repro_torch.kernels.draft_decode.ref import (
    attn_cached_ref, head_ref, post_attn_ref, qkv_rope_ref,
)

__all__ = ["DraftDecoder", "draft_decode_supported", "qkv_rope", "attn_cached",
           "post_attn", "head", "qkv_rope_ref", "attn_cached_ref", "post_attn_ref",
           "head_ref"]
