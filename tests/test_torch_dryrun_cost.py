"""Port parity: the dry-run's per-device cost on a 1x1 mesh against the
reference's HLO walker.

``repro_torch.launch.dryrun.run_combo`` on a (1, 1) mesh is held to
``repro.launch.hlo_cost.analyze`` of the reference's ``lower_train`` /
``lower_prefill`` / ``lower_serve`` on ``jax.make_mesh((1, 1), ("data",
"model"))`` (auto axes), one small ``InputShape`` (B 2) per mode, for every
reduced family:

  * ``flops`` at rel 1e-6 for reduced SmolLM in all three modes, and for
    every family in prefill and decode;
  * in training, the gaps that remain, each explained by op below (they
    are counts of real work the two programs do differently, not
    tolerance);
  * ``argument_size_in_bytes`` equals the reference's ``memory_analysis()``
    up to its scalar step counters (the port's are Python ints), less, in
    the encoder-decoder's decode step, the encoder's weights: ``jax.jit``
    drops arguments the step never reads, the port passes the whole
    tree;
  * neither records a collective.

The gaps in training:

  * ``ce_fold`` — with one chunk of the chunked CE head (S <= 512) the
    reference's loop has a single trip, and XLA merges the chunk's
    checkpointed forward (B·512·D·V multiply-adds) with its recompute; the
    port runs both. At S = 1024 (two chunks) the counts agree, which the
    SmolLM row shows;
  * ``ssd_backward`` (zamba2) — the gradients of the SSD's three-operand
    einsums: JAX transposes their broadcast products into dot_generals that
    reduce over the head or state axis, 4 of 2·B·NC·L·L·H (one of them
    2·B·NC·L·H·P, the same at P = L = 32) and 4 of 2·B·NC·L·N·H flops at
    B 2, 2 chunks of L 32, H 8, N 16; torch takes a multiply and a sum (no
    matmul);
  * ``wkv_backward`` (rwkv6) — autograd skips the gradients no output
    reads: the last chunk's state update (its product is never used) and
    the first chunk's zero incoming state, 6 batched matmuls of 2·B·H·C·d²
    flops (C 32, d 64, H 4) over the 2 layers; and torch contracts the u
    bonus's three-operand einsum as batched matmuls with a unit dim, 4
    more of 2·B·C·H·d in its backward than XLA's dots.
"""
import os

import jax
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import hlo_cost
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun as tdry
from repro_torch.models import transformer as ttfm
from repro_torch.tree import tree_leaves

B = 2
MODES = ("train", "prefill", "decode")
SCALAR_COUNTERS_BYTES = 64


def _reference_dryrun():
    """``repro.launch.dryrun``, imported after JAX has its devices (the
    module appends a 512-device flag to XLA_FLAGS for a JAX that has not
    started yet); the variable is put back as it was."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def _gap(arch, mode, s):
    """The port's flops less the reference's, as explained above."""
    cfg = jbase.get_reduced(arch)
    if mode != "train":
        return 0
    gap = 0
    if s <= 512:                                   # ce_fold
        gap += 2 * B * 512 * cfg.d_model * cfg.vocab
    if arch == "zamba2_1p2b":                      # ssd_backward
        nc, ln, h, n = s // cfg.ssm_chunk, cfg.ssm_chunk, cfg.ssm_heads, \
            cfg.d_state
        gap -= 4 * 2 * B * nc * ln * ln * h + 4 * 2 * B * nc * ln * n * h
    if arch == "rwkv6_7b":                         # wkv_backward
        h, d, c = cfg.ssm_heads, cfg.ssm_head_dim, 32
        gap -= 6 * 2 * B * h * c * d * d
        gap += 4 * 2 * B * c * h * d
    return gap


def _unread(arch, mode):
    """Bytes of the parameters the step never reads (the encoder's in the
    encoder-decoder's decode step, which takes the encoder output)."""
    cfg = tbase.get_reduced(arch)
    if mode != "decode" or not cfg.is_encdec:
        return 0
    params = tdry.abstract(lambda g: ttfm.init_lm(g, cfg, "cpu"),
                           torch.Generator())
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(params["enc"]))


def _compare(arch, mode, s):
    jd = _reference_dryrun()
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    lower = {"train": jd.lower_train, "prefill": jd.lower_prefill,
             "decode": jd.lower_serve}[mode]
    compiled = lower(jbase.get_reduced(arch), jbase.InputShape(
        "tiny", s, B, mode), mesh).compile()
    ref = hlo_cost.analyze(compiled.as_text())
    ref_mem = jd.memory_dict(compiled)
    rec = tdry.run_combo(arch, "tiny", False,
                         cfg_override=tbase.get_reduced(arch), device="cpu",
                         shape=tbase.InputShape("tiny", s, B, mode),
                         debug_mesh=(1, 1))
    assert rec["ok"], rec.get("traceback")
    assert rec["flops"] - _gap(arch, mode, s) == pytest.approx(
        ref["flops"], rel=1e-6), (arch, mode, rec["flops"], ref["flops"])
    got = rec["memory"]["argument_size_in_bytes"] - _unread(arch, mode)
    want = ref_mem["argument_size_in_bytes"]
    assert 0 <= want - got <= SCALAR_COUNTERS_BYTES, (arch, mode, got, want)
    assert rec["collectives"] == {} and ref["collectives"] == {}
    assert rec["collective_bytes"] == 0 and rec["n_devices"] == 1


@pytest.mark.parametrize("mode", MODES)
def test_smollm_cost_matches_reference(mode):
    # two CE chunks in training: no single-trip loop for XLA to fold
    _compare("smollm_360m", mode, 1024 if mode == "train" else 64)


@pytest.mark.parametrize("arch", [a for a in jbase.ARCH_IDS
                                  if a != "smollm_360m"])
def test_family_cost_matches_reference(arch):
    for mode in MODES:
        _compare(arch, mode, 64)


def test_single_chunk_ce_is_the_smollm_train_gap():
    _compare("smollm_360m", "train", 64)
