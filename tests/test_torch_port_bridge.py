"""The port's torch bridge (``horovod_tpu_torch.torch.tpu_compile``) against
the JAX package's (``horovod_tpu.torch.compile.tpu_compile``) on a tiny HF
``BertForMaskedLM``, both routing attention through their flash kernels
(``HVDTPU_BRIDGE_FLASH=always``; the port's plain versions and the Pallas
kernels in interpret mode on the CPU). Also: the stand-in BERT that
``chip_smoke.py`` trains on the card equals HF's model.

Tolerances, fp32 throughout: losses 1e-5 and logits 1e-4 (the two bridges
differ only in summation order); parameters after 3 AdamW steps 2e-6 (as
tests/test_torch_port_train.py); the flash dropout path against the einsum
lowering, which apply the same keep-masks in another order, 1e-5 on the
loss and 1e-4 on the gradients.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.torch import compile as tcompile

transformers = pytest.importorskip("transformers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, vocab_size=512, max_position_embeddings=64)
INPUTS = ["input_ids", "labels"]


@pytest.fixture
def port(monkeypatch):
    monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", "always")
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _hf_bert(**overrides):
    torch.manual_seed(0)
    cfg = transformers.BertConfig(**dict(TINY, **overrides))
    return transformers.BertForMaskedLM(cfg), cfg


def _ids(cfg, batch=2, seq=16, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(batch, seq)))


def test_eval_loss_and_logits_match_the_jax_bridge(port):
    from horovod_tpu.torch.compile import tpu_compile as jax_compile
    model, cfg = _hf_bert()
    ids = _ids(cfg)
    want = jax_compile(model, input_names=INPUTS)(input_ids=ids, labels=ids)
    got = tcompile.tpu_compile(model)(input_ids=ids, labels=ids)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4,
                               rtol=1e-4)
    with torch.no_grad():
        eager = model.eval()(input_ids=ids, labels=ids)
    np.testing.assert_allclose(got["logits"].numpy(), eager.logits.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_three_adamw_steps_match_the_jax_bridge(port, hvd):
    import optax
    from horovod_tpu.torch.compile import tpu_compile as jax_compile
    # Both dropout probabilities 0: the two bridges draw different random
    # numbers. Batch 8: one sample per device of the JAX package's mesh;
    # labels = ids, so every sample has the same number of valid tokens
    # and the mean of per-device losses is the global mean.
    model, cfg = _hf_bert(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    ids = _ids(cfg, batch=8)
    batch = {"input_ids": ids, "labels": ids}
    jcomp = jax_compile(model, input_names=INPUTS)
    jstep = jcomp.make_train_step(optax.adamw(1e-4))
    comp = tcompile.tpu_compile(model)
    step = comp.make_train_step(torch.optim.AdamW(
        comp.params.values(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4))
    for i in range(3):
        want = float(jstep(batch))
        got = float(step(batch, rng=i))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert set(comp.params) == set(jcomp.params)
    for name, p in comp.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jcomp.params[name]),
                                   atol=2e-6, rtol=2e-6, err_msg=name)
    # copy_params_to_module writes the trained weights back, ties included
    comp.copy_params_to_module(model)
    state = model.state_dict()
    for name, p in comp.params.items():
        assert torch.equal(state[name], p.detach())
    assert torch.equal(state["cls.predictions.decoder.weight"],
                       comp.params["bert.embeddings.word_embeddings.weight"])


def _loss_and_grads(comp, batch, rng):
    loss = comp.loss_fn()(comp.params, batch, rng=rng)
    grads = torch.autograd.grad(loss, list(comp.params.values()))
    return loss.detach(), grads


def test_flash_mask_dropout_equals_the_einsum_lowering(port, monkeypatch):
    model, cfg = _hf_bert()
    ids = _ids(cfg)
    batch = {"input_ids": ids, "labels": ids}
    runs = {}
    for route in ("always", "never"):
        monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", route)
        runs[route] = _loss_and_grads(tcompile.tpu_compile(model), batch, 5)
    l_f, g_f = runs["always"]
    l_e, g_e = runs["never"]
    np.testing.assert_allclose(float(l_f), float(l_e), atol=1e-5, rtol=1e-5)
    for a, b in zip(g_f, g_e):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    # dropout was on: another seed gives another loss, the same seed the
    # same one
    comp = tcompile.tpu_compile(model)
    again, _ = _loss_and_grads(comp, batch, 5)
    other, _ = _loss_and_grads(comp, batch, 6)
    assert float(again) == float(l_e)
    assert float(other) != float(l_e)


def test_dropout_mode_decision_matches_the_jax_bridge(monkeypatch):
    import jax
    import jax.numpy as jnp
    from horovod_tpu.ops import flash_attention as jfa
    from horovod_tpu.torch import compile as jcompile
    monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", "always")
    monkeypatch.setenv("HVDTPU_FLASH_DROPOUT_MASK_LIMIT", "4096")
    # The JAX package decides off-TPU as on a TPU when _interpret is False.
    monkeypatch.setattr(jfa, "_interpret", lambda: False)
    chosen = []

    def spy(q, k, v, dropout_mask=None, dropout_seed=None, **kw):
        chosen.append("mask" if dropout_mask is not None else "seed")
        return q
    monkeypatch.setattr(jfa, "flash_attention", spy)
    # mask bytes 2*B*H*Sq*Sk: 3968, 4096 (at the limit), 4224
    shapes = [((1, 2, 31, 8), 32), ((1, 2, 32, 8), 32), ((1, 2, 32, 8), 33)]
    for mode in ("auto", "mask", "prng"):
        monkeypatch.setenv("HVDTPU_FLASH_DROPOUT", mode)
        for q_shape, s_k in shapes:
            q = jnp.zeros(q_shape)
            k = jnp.zeros(q_shape[:2] + (s_k, q_shape[3]))
            jcompile._sdpa(jax.random.PRNGKey(0), True, q, k, k,
                           dropout_p=0.1)
            # mask and prng choose as the JAX bridge does; under auto the
            # JAX bridge keeps the mask within its limit (a TPU
            # measurement), the port takes the seed on CUDA at every size
            # (an H100 measurement)
            want = "seed" if mode == "auto" else chosen[-1]
            assert tcompile.dropout_mode(on_cuda=True) == want, \
                (mode, q_shape, s_k)
            # on the CPU both packages take the explicit mask
            assert tcompile.dropout_mode(on_cuda=False) == "mask"
    assert chosen == ["mask", "mask", "seed"] + ["mask"] * 3 + ["seed"] * 3


def test_padding_mask_takes_the_einsum_lowering_with_a_warning(port,
                                                                monkeypatch):
    model, cfg = _hf_bert()
    model.eval()
    ids = _ids(cfg)
    attn = torch.ones_like(ids)
    attn[:, -4:] = 0   # real padding
    monkeypatch.setattr(tfa, "_bridge_fallback_noted", set())
    calls = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **k: calls.append(1))
    comp = tcompile.tpu_compile(model)
    with pytest.warns(UserWarning, match="not statically all-keep"):
        out = comp(input_ids=ids, attention_mask=attn, labels=ids)
    assert not calls
    with torch.no_grad():
        eager = model(input_ids=ids, attention_mask=attn, labels=ids)
    np.testing.assert_allclose(float(out["loss"]), float(eager.loss),
                               atol=1e-5, rtol=1e-5)
    # an all-ones mask on the CPU is inspected and dropped: flash again
    monkeypatch.undo()
    monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", "always")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = comp(input_ids=ids, attention_mask=torch.ones_like(ids),
                   labels=ids)
    np.testing.assert_allclose(float(out["loss"]), float(
        model(input_ids=ids, labels=ids).loss), atol=1e-5, rtol=1e-5)


def test_cuda_attention_runs_on_the_kernels_or_raises(monkeypatch):
    # On CUDA tensors the bridge has no einsum lowering: a call the kernels
    # cannot take raises, whatever HVDTPU_BRIDGE_FLASH says, and never
    # warns its way past.
    from torch._subclasses.fake_tensor import FakeTensorMode
    calls = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, *a, **k: calls.append(k) or q)
    monkeypatch.setattr(tfa, "_bridge_fallback_noted", set())
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("error")
        q = torch.empty(2, 4, 64, 64, device="cuda")
        wide = torch.empty(2, 4, 64, 256, device="cuda")
        flat = torch.empty(4, 64, 64, device="cuda")
        keep_all = torch.ones(64, 64, dtype=torch.bool, device="cuda")
        cases = [((q, q, q), {"attn_mask": keep_all},
                  r"torch.bool attn_mask of shape \(64, 64\)"),
                 ((q, q, q), {"attn_mask": torch.zeros(64, 64,
                                                       device="cuda")},
                  "attn_mask of shape"),
                 ((wide, wide, wide), {}, r"\(2, 4, 64, 256\)"),
                 ((flat, flat, flat), {}, r"\(4, 64, 64\)")]
        for route in ("auto", "always"):
            monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", route)
            for args, kwargs, match in cases:
                with pytest.raises(NotImplementedError, match=match):
                    tcompile._sdpa(None, *args, **kwargs)
            tcompile._sdpa(None, q, q, q, attn_mask=None)
        assert len(calls) == 2
        monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", "never")
        with pytest.raises(ValueError, match="never"):
            tcompile._sdpa(None, q, q, q)
    assert len(calls) == 2


@pytest.mark.parametrize("mode", ["mask", "seed"])
def test_chip_smoke_dense_witness_equals_the_flash_path(port, monkeypatch,
                                                        mode):
    # [bert-check] replaces flash_attention by chip_smoke's dense attention,
    # which the bridge hands the same keep-masks or seeds: on the CPU the
    # two give the loss and gradients of the flash path's plain versions.
    smoke = _chip_smoke()
    monkeypatch.setattr(tcompile, "dropout_mode", lambda *a: mode)
    model, cfg = _hf_bert()
    ids = _ids(cfg)
    batch = {"input_ids": ids, "labels": ids}
    l_f, g_f = _loss_and_grads(tcompile.tpu_compile(model), batch, 5)
    monkeypatch.setattr(tfa, "flash_attention", smoke.dense_attention(tfa))
    l_d, g_d = _loss_and_grads(tcompile.tpu_compile(model), batch, 5)
    np.testing.assert_allclose(float(l_d), float(l_f), atol=1e-5, rtol=1e-5)
    for a, b in zip(g_d, g_f):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    # dropout was on: the undropped loss differs
    monkeypatch.setattr(tcompile, "dropout_mode", pytest.fail)
    l_0, _ = _loss_and_grads(tcompile.tpu_compile(model), batch, None)
    assert abs(float(l_0) - float(l_d)) > 1e-4


def test_bridge_contract_checks(port):
    model, _ = _hf_bert()
    with pytest.raises(NotImplementedError, match="analyzer"):
        tcompile.tpu_compile(model, verify=True)
    comp = tcompile.tpu_compile(model, input_names=INPUTS)
    assert "cls.predictions.decoder.weight" not in comp.params
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in comp.params.values())
    with pytest.raises(ValueError, match="params.values"):
        comp.make_train_step(torch.optim.SGD(model.parameters(), lr=0.1))


def test_bf16_compute_keeps_norms_softmax_and_loss_in_fp32(port):
    # As the JAX lowerings: LayerNorm, softmax and cross-entropy of bf16
    # activations are computed in fp32 (then rounded once, except the
    # loss). The bridge reroutes cross-entropy to fp32 logits; torch's own
    # LayerNorm and softmax compute bf16 inputs in fp32.
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(16, 32)
            self.ln = torch.nn.LayerNorm(32)

        def forward(self, x, labels):
            h = self.ln(self.fc(x))
            p = torch.nn.functional.softmax(h, -1)
            q = torch.softmax(h, -1, torch.float32)
            loss = torch.nn.functional.cross_entropy(h, labels)
            return {"h": h, "p": p, "q": q, "loss": loss}

    torch.manual_seed(0)
    net = Net()
    x = torch.randn(8, 16).bfloat16()
    labels = torch.randint(0, 32, (8,))
    out = tcompile.tpu_compile(net, compute_dtype=torch.bfloat16)(
        x=x, labels=labels)
    pre = torch.nn.functional.linear(x, net.fc.weight.bfloat16(),
                                     net.fc.bias.bfloat16())
    h = torch.nn.functional.layer_norm(pre.float(), (32,),
                                       net.ln.weight, net.ln.bias)
    assert out["h"].dtype == torch.bfloat16
    assert torch.equal(out["h"], h.bfloat16())
    hb = h.bfloat16().float()
    assert out["p"].dtype == torch.bfloat16
    assert torch.equal(out["p"], torch.softmax(hb, -1).bfloat16())
    assert out["q"].dtype == torch.float32
    assert torch.equal(out["q"], torch.softmax(hb, -1))
    assert out["loss"].dtype == torch.float32
    assert torch.equal(out["loss"],
                       torch.nn.functional.cross_entropy(hb, labels))


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_chip_smoke_standin_is_hf_bert(port):
    smoke = _chip_smoke()
    hf, cfg = _hf_bert()
    standin = smoke.BertForMaskedLM(smoke.BertConfig(**TINY))
    standin.load_state_dict(hf.state_dict(), strict=True)
    assert [n for n, _ in standin.named_parameters()] == \
        [n for n, _ in hf.named_parameters()]
    ids = _ids(cfg)
    with torch.no_grad():
        want = hf.eval()(input_ids=ids, labels=ids)
        got = standin.eval()(input_ids=ids, labels=ids)
    torch.testing.assert_close(got["logits"], want.logits, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(got["loss"], want.loss, atol=1e-5, rtol=1e-5)
    # Through the bridge in train mode with one seed, the two draw the same
    # dropout at the same sites: the same loss.
    batch = {"input_ids": ids, "labels": ids}
    l_hf, _ = _loss_and_grads(tcompile.tpu_compile(hf), batch, 3)
    l_si, _ = _loss_and_grads(tcompile.tpu_compile(standin), batch, 3)
    np.testing.assert_allclose(float(l_si), float(l_hf), atol=1e-5,
                               rtol=1e-5)


def test_chip_smoke_standin_initialisation(port):
    smoke = _chip_smoke()
    cfg = smoke.BertConfig(**TINY)
    gen = torch.Generator().manual_seed(0)
    model = smoke.BertForMaskedLM(cfg, generator=gen)
    emb = model.bert.embeddings.word_embeddings.weight
    assert model.cls.predictions.decoder.weight is emb
    assert float(emb[cfg.pad_token_id].abs().max()) == 0.0
    assert abs(float(emb[1:].std()) - cfg.initializer_range) < 2e-3
    again = smoke.BertForMaskedLM(cfg, generator=gen.manual_seed(0))
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
