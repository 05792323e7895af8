from .samplers import (
    Candidates,
    SamplerParams,
    SamplerState,
    build_dry_sequences,
    make_state,
    sample_logits,
)

__all__ = [
    "Candidates", "SamplerParams", "SamplerState",
    "build_dry_sequences", "make_state", "sample_logits",
]
