"""PyTorch port, LM training for the dense models beyond internlm2:
qk-norm (qwen3-32b), GeGLU with head dim 256 (gemma-7b) and padded heads
(phi4-mini-3.8b at ``tp_multiple=8``: 4 query heads padded to 8, 2 kv
heads replicated to 8; the smoke variants' ``tp_multiple=1`` pads
nothing). ``loss_fn``'s loss and every gradient in float32 and bf16
compute, forward's logits, remat, and 3 train steps, against the JAX
package on the same numpy inputs and the reference's weights
(tests/lm_train_oracle.py)."""
from __future__ import annotations

import pytest

import lm_train_oracle as oracle
from repro_torch.configs.base import ShapeConfig
from repro_torch.train.steps import check_trainable, make_batch_specs
from torch_threads import one_torch_thread  # noqa: F401

CASES = {"qwen3-32b": {}, "gemma-7b": {},
         "phi4-mini-3.8b-tp8": {"tp_multiple": 8}}


def _arch(case: str) -> str:
    return case.removesuffix("-tp8")


@pytest.mark.parametrize("case", CASES)
def test_trainable_with_token_batches(case):
    """The trainability check admits each (qk-norm, GeGLU, padded heads),
    and its batch is tokens and labels alone; tp8 really pads."""
    cfg = oracle.cfgs(_arch(case), **CASES[case])[1]
    check_trainable(cfg)
    specs = make_batch_specs(cfg, ShapeConfig("t", "train", 8, 2))
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        "tokens": (2, 8), "labels": (2, 8)}
    assert (cfg.qk_norm, cfg.act, cfg.phys_heads > cfg.n_heads) == {
        "qwen3-32b": (True, "silu", False), "gemma-7b": (False, "gelu", False),
        "phi4-mini-3.8b-tp8": (False, "silu", True)}[case]


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_and_its_gradients_match_the_reference(case):
    """See oracle.check_loss_and_grads: float32 loss, ce and lb rtol 1e-5,
    gradients rtol 1e-4 / atol 1e-6, logits 1e-5; bf16 within 2^-6 and
    the 1.5x noise bound."""
    oracle.check_loss_and_grads(_arch(case), **CASES[case])


@pytest.mark.parametrize("case", CASES)
def test_remat_gives_the_same_bits(case):
    oracle.check_remat_bits(_arch(case), **CASES[case])


@pytest.mark.parametrize("case", CASES)
def test_train_steps_match_the_reference(case):
    """3 build_train_step steps and their grad_accum=2 twin against the
    reference's steps (tests/adam_close.py: rtol 2e-4, atol 2e-5). phi4
    at tp8 alone takes adam_close's exemption: blocks/mlp/wg[0, 13, 55]
    has a first gradient of ~5.5e-9, which AdamW turns into ~0.35 lr,
    and the two packages' roundoff in it leaves the param 3.5-3.7e-5 apart
    (1.05-1.11 of the limit) from step 1 on; its gradient is held to rtol
    1e-4, atol 1e-6."""
    oracle.check_train_steps(_arch(case), exempt=case == "phi4-mini-3.8b-tp8",
                             **CASES[case])
