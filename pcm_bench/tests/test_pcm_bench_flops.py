"""The operation count and the roofline arithmetic of the benchmark."""

import chip_smoke
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pcm_bench import flops, roofline
from pcm_bench.traffic.train_cached import reference_model
from tiny import TINY_MMDIT

BOUND_CASES = [(2.5e12, "bf16", 3.1e9), (1e9, "fp32", 8e9), (7e11, "int8", 2e8)]
ATTN_CASES = [(4, 4096, 4096, 10, 64), (8, 4250, 4250, 24, 64), (1, 16384, 16384, 1, 512)]


@pytest.mark.parametrize("case", BOUND_CASES)
def test_bound_is_chip_smokes(case):
    assert roofline.bound(*case) == chip_smoke.bound(*case)


@pytest.mark.parametrize("shape", ATTN_CASES)
@pytest.mark.parametrize("products,outputs", [(2, 1), (4, 2), (3, 1)])
def test_attention_bound_is_chip_smokes(shape, products, outputs):
    assert roofline.attn_bound(shape, products, outputs) == \
        chip_smoke.attn_bound(shape, products, outputs)


def test_flop_count_of_a_tiny_mmdit_forward_by_hand():
    """One joint block (the last, context-pre-only), batch 1, an 8x8 latent
    of patch 2 (16 image tokens) and 8 context tokens: 2·m·k·n a product,
    2·positions·C_out·C_in·k² the patch conv, 4·S·S·d·h the attention."""
    cfg = {"family": "sd3", "mmdit": dict(TINY_MMDIT, num_layers=1),
           "lora": {"rank": 4, "alpha": 4.0, "targets": []}}
    model = reference_model(cfg, "meta")
    m = torch.device("meta")
    dim, si, sc, s = 32, 16, 8, 24
    with FlopCounterMode(display=False) as fc:
        model(torch.empty(1, 8, 8, 4, device=m), torch.zeros(1, device=m),
              torch.empty(1, sc, 32, device=m), torch.empty(1, 32, device=m))

    def mm(rows, k, n):
        return 2 * rows * k * n

    hand = (16 * 32 * 4 * 2 * 2 * 2  # patch conv
            + mm(1, 256, dim) + mm(1, dim, dim) + mm(1, 32, dim) + mm(1, dim, dim)
            + mm(sc, 32, dim)  # context embedder
            + mm(1, dim, 6 * dim) + mm(1, dim, 2 * dim)  # AdaLN-Zero, AdaLN-continuous
            + 3 * mm(si, dim, dim) + 3 * mm(sc, dim, dim)  # joint q, k, v
            + 4 * s * s * 16 * 2  # attention: QKᵀ and PV
            + mm(si, dim, dim) + mm(si, dim, 4 * dim) + mm(si, 4 * dim, dim)
            + mm(1, dim, 2 * dim) + mm(si, dim, 16))  # norm_out, proj_out
    assert fc.get_total_flops() == hand


def test_the_training_count_adds_the_step_parts():
    """A step counts the CFG teacher (two rows), the target and the student's
    forward and backward: more than four forwards of a row, less than seven."""
    cfg = {"family": "sd3", "mmdit": dict(TINY_MMDIT), "prompt_len": 8,
           "lora": {"rank": 4, "alpha": 4.0, "targets": ["to_q", "to_k", "to_v"]}}
    model = reference_model(cfg, "meta")
    m = torch.device("meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.empty(1, 8, 8, 4, device=m), torch.zeros(1, device=m),
              torch.empty(1, 8, 32, device=m), torch.empty(1, 32, device=m))
    one = fc.get_total_flops()
    got = flops.count(cfg, hw=8)
    assert 4 * one < got["flops_per_sample"]["train"] < 7 * one
    assert got["attention"]["layers"] == 2
    assert got["attention"]["fwd_flops_per_sample"] == 2 * 4 * 24 * 24 * 16 * 2
