"""`kq_plan`, the tiling of the port's K3 / K13 kernel (csrc/kq_matmul.cu),
on the CPU: at every shape the port sends to it (the TinyLlama-1.1B's
projections and output head, the committed fixtures' widths), every kind
and IQ scale group, and T in {1, 8, 16, 128, 300, 512}, the tiles cover
the (T, out_f) output exactly once, the K steps and the split cover in_f
in whole superblocks (every packed field's unit), the split does not
depend on T within a variant, and a shape the kernel does not take
raises."""
from __future__ import annotations

import pytest

from koboldcpp_tpu_torch.ops import quant_matmul as qm

# (out_f, in_f): the 1.1B's wqkv, wo, w_gateup, w_down and output head; the
# fixtures' (hidden 256, ffn 512) projections
SHAPES = ((2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632),
          (32000, 2048), (256, 256), (512, 256), (1024, 256), (256, 512),
          (512, 512))
TS = (1, 8, 16, 128, 300, 512)
# (kind, scale group G): the IQ kinds at each G their files use or allow
KINDS = tuple((k, 0) for k in ("q4_k", "q6_k", "q5_k", "q8_0", "q2_k",
                               "q3_k", "q4_k_i8")) \
    + tuple((k, g) for k in ("iq2p", "iq3px", "iq3ps", "iq1p")
            for g in (8, 16, 32))
# the bytes of each packed field per row and superblock (256 columns)
UNIT_BYTES = {"qs2": 128, "ql": 128, "qh": 64, "q": 256, "qs": 64,
              "hmask": 32, "sg": 32}


def _parts(nsb: int, split: int) -> list[list[int]]:
    """The superblocks each part of a block takes: every split-th one."""
    return [list(range(p, nsb, split)) for p in range(split)]


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("kind,G", KINDS)
def test_plan_covers_output_and_k(kind, G, T):
    for out_f, in_f in SHAPES:
        plan = qm.kq_plan(kind, T, out_f, in_f, G)
        assert plan.variant == ("swap" if T <= qm.KQ_SWAP_MAX_T else "wgmma")
        gx, gy = plan.grid
        # weight-row tiles: disjoint, contiguous, exactly out_f rows
        assert gx * plan.rows == out_f
        # token tiles: the last one may be ragged, none is empty
        assert (gy - 1) * plan.tokens < T <= gy * plan.tokens
        # K: whole superblocks, each in exactly one part of the split
        assert in_f % qm.KQ_K_STEP == 0
        nsb = in_f // qm.KQ_K_STEP
        parts = _parts(nsb, plan.split)
        assert sorted(sb for p in parts for sb in p) == list(range(nsb))
        if plan.variant == "wgmma":
            # every part takes the same number of superblocks
            assert nsb % plan.split == 0
            assert plan.rows in (64, 128) and plan.tokens in (64, 128)
            # one warpgroup per 64 rows and K part: at most 512 threads
            assert plan.rows * plan.split <= 256
        else:
            assert (plan.rows, plan.tokens, plan.split) == (16, 8, 4)
        # a superblock holds whole 16-byte pieces of every packed field
        # (the kernel's copies), whole scale groups and whole affine groups
        grp = G or (32 if kind in ("q4_k", "q5_k", "q8_0", "q4_k_i8")
                    else 16)
        assert qm.KQ_K_STEP % grp == 0
        for nbytes in (*UNIT_BYTES.values(), 2 * qm.KQ_K_STEP // grp):
            assert nbytes % 16 == 0


@pytest.mark.parametrize("kind,G", KINDS)
def test_split_does_not_depend_on_t(kind, G):
    for out_f, in_f in SHAPES:
        by_variant: dict[str, set[int]] = {}
        for T in range(1, 520, 7):
            plan = qm.kq_plan(kind, T, out_f, in_f, G)
            by_variant.setdefault(plan.variant, set()).add(plan.split)
        assert all(len(s) == 1 for s in by_variant.values()), by_variant
        assert by_variant["wgmma"] == {qm.kq_split(out_f, in_f)}


@pytest.mark.parametrize("kind,T,out_f,in_f,G", (
    ("dense", 16, 2048, 2048, 0),        # not a kind of the kernel
    ("q6_k_i8f", 16, 2048, 2048, 0),     # an expanded kind: T=1 only
    ("q4_k", 0, 2048, 2048, 0),          # no tokens
    ("q4_k", 16, 2048, 2000, 0),         # in_f not whole superblocks
    ("q8_0", 16, 2000, 2048, 0),         # out_f not whole 64-row tiles
    ("iq2p", 16, 2048, 2048, 4),         # no such IQ scale group
    ("iq1p", 16, 2048, 2048, 0),         # an IQ kind without its group
    ("q4_k", 128 * 65536 + 1, 2048, 2048, 0),  # more token tiles than a grid
))
def test_plan_raises_for_shapes_the_kernel_does_not_take(kind, T, out_f,
                                                          in_f, G):
    with pytest.raises(ValueError):
        qm.kq_plan(kind, T, out_f, in_f, G)
