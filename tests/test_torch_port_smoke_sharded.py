"""``chip_smoke.py``'s ``[sharded]`` checks on the CPU: the verdict on the
one-rank job's results, the bounds at the tensor-parallel ranks' kernel
shapes, and the 2-D ZeRO inputs and loss it shares with the card tests."""

import copy
import math

import pytest
import torch

import chip_smoke


def _sharded_result():
    launches = dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), 24)
    return {
        "backend": "nccl",
        "lm": {"losses": [10.8, 10.1, 9.7], "ref_losses": [10.8, 10.1, 9.7],
               "params_equal": True, "launches": [launches] * 3},
        "group": {"bit_equal": True},
        "twod": {"losses": [3.0, 2.0, 1.0], "plain_losses": [3.0, 2.0, 1.0],
                 "max_param_diff": 0.0},
    }


@pytest.mark.parametrize("path,value,phrase", [
    (None, None, None),
    (("lm", "losses"), [10.8, 10.1, 9.70001], "not the unsharded"),
    (("lm", "params_equal"), False, "parameters after the steps"),
    (("lm", "launches", 1, "bwd_dq"), 12, "launches per step"),
    (("lm", "losses"), [10.8, math.nan, 9.7], "unsharded"),
    (("group", "bit_equal"), False, "round trip"),
    (("twod", "max_param_diff"), 1e-7, "TwoDZero"),
    (("twod", "losses"), [3.0, 2.0, 1.5], "TwoDZero"),
    (("backend",), "gloo", "not NCCL"),
])
def test_sharded_verdict_holds_each_check(path, value, phrase):
    res = _sharded_result()
    if path is None:
        assert chip_smoke.sharded_verdict(res) == []
        return
    res = copy.deepcopy(res)
    node = res
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    bad = chip_smoke.sharded_verdict(res)
    assert bad and any(phrase in b for b in bad), bad


@pytest.mark.parametrize("label,heads", [("tp2", 8), ("tp4", 4)])
def test_tp_local_bounds_are_the_heads_share(label, heads):
    s, d = chip_smoke.MAIN["seq"], chip_smoke.MAIN["d"]
    bh = chip_smoke.SHARD_TP_BH[label]
    assert bh == chip_smoke.TRAIN_BATCH * heads
    pairs = chip_smoke.visible_pairs(s, s, 0, 0, s, True)
    for kind in ("fwd", "bwd_dkv", "bwd_dq"):
        got, by = chip_smoke.bound(kind, bh, s, s, d, pairs, 2)
        whole, _ = chip_smoke.bound(kind, chip_smoke.MAIN["bh"], s, s, d,
                                    pairs, 2)
        assert got == pytest.approx(whole * heads / 16, rel=1e-12)
        assert by == "bytes"


def test_twod_inputs_and_loss_are_the_jax_tests_at_mlp_widths():
    dims = dict(d=8, f=4, tokens=16)
    p, b = chip_smoke.twod_inputs("cpu", dims)
    assert p["mlp_in"]["kernel"].shape == (8, 4)
    assert p["mlp_in"]["bias"].shape == (4,) and p["scale"].shape == (8,)
    assert b.shape == (16, 8)
    y = (b * p["scale"]) @ p["mlp_in"]["kernel"] + p["mlp_in"]["bias"]
    assert torch.equal(chip_smoke.twod_loss(p, b), torch.sum(y * y))
    # column-decomposable: the column halves' partial losses sum to it
    halves = [chip_smoke.twod_loss(
        {"mlp_in": {"kernel": p["mlp_in"]["kernel"][:, i:i + 2],
                    "bias": p["mlp_in"]["bias"][i:i + 2]},
         "scale": p["scale"]}, b) for i in (0, 2)]
    torch.testing.assert_close(sum(halves), chip_smoke.twod_loss(p, b))
    q, _ = chip_smoke.twod_inputs("cpu", dims)
    assert torch.equal(q["scale"], p["scale"])
