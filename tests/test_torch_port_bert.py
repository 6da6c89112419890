"""The port's BertModel, padding mask and remat against the JAX package's
flax models, on the CPU at a small size (vocab 1024, hidden 128, 2 layers,
4 heads, seq 64): the same flax weights, converted by ``params_from_flax``,
and the same seeded tokens give the same logits, loss and gradients. The
flash path runs the kernels' plain versions on the port's side and the
Pallas kernels in interpret mode on the JAX side.

Tolerances are those of ``test_torch_port_transformer.py``: fp32 2e-5 on
logits, 1e-5 on the loss, 2e-5 of each gradient's scale (the packages
differ in fp32 summation order); bf16 8e-2, 5e-3 and 5e-2 (each framework
rounds activations to bf16 at other points). Remat against no remat in
the port is exact (``torch.equal``): the recompute runs the same
operations on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import BertConfig as JBertConfig
from horovod_tpu.models import BertModel as JBert
from horovod_tpu.models import TransformerConfig as JConfig
from horovod_tpu.models import TransformerLM as JLM
from horovod_tpu_torch.models import (BertConfig, BertModel,
                                      TransformerConfig, TransformerLM,
                                      params_from_flax)

SMALL = dict(vocab_size=1024, hidden=128, layers=2, heads=4, max_len=64)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": dict(logits=2e-5, loss=1e-5, grad=2e-5),
       "bf16": dict(logits=8e-2, loss=5e-3, grad=5e-2)}
LENGTHS = (64, 40)   # row 1 is right-padded after 40 tokens


def _inputs():
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, SMALL["vocab_size"], size=(2, SMALL["max_len"]))
    targets = rng.randint(0, SMALL["vocab_size"], size=(2, SMALL["max_len"]))
    mask = np.arange(SMALL["max_len"])[None, :] < np.array(LENGTHS)[:, None]
    return tokens, targets, mask


def _setup(impl="einsum", dtype="fp32", remat=False, bert=True):
    jdt, tdt = DTYPES[dtype]
    kw = dict(SMALL, attention_impl=impl, remat=remat)
    if bert:
        jmodel = JBert(JBertConfig(**kw, dtype=jdt))
        cfg = BertConfig(**kw, dtype=tdt)
        model = BertModel(cfg)
    else:
        jmodel = JLM(JConfig(**kw, dtype=jdt))
        cfg = TransformerConfig(**kw, dtype=tdt)
        model = TransformerLM(cfg)
    tokens, targets, mask = _inputs()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    model.load_state_dict(params_from_flax(jax.device_get(params), cfg))
    return jmodel, params, model, cfg, tokens, targets, mask


def _jax_loss(jmodel, tokens, targets, mask=None):
    def loss(p):
        logits = jmodel.apply(p, jnp.asarray(tokens),
                              None if mask is None else jnp.asarray(mask))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(targets)).mean()
    return loss


def _torch_run(model, tokens, targets, mask=None):
    model.zero_grad()
    logits = model(torch.as_tensor(tokens),
                   None if mask is None else torch.as_tensor(mask))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.as_tensor(targets).reshape(-1))
    loss.backward()
    return logits.detach(), loss.detach(), {
        n: p.grad.clone() for n, p in model.named_parameters()}


def _check_against_flax(jmodel, params, model, cfg, tokens, targets, mask,
                        tol):
    jlogits = np.asarray(jmodel.apply(
        params, jnp.asarray(tokens),
        None if mask is None else jnp.asarray(mask)))
    jloss, jgrads = jax.value_and_grad(
        _jax_loss(jmodel, tokens, targets, mask))(params)
    logits, loss, grads = _torch_run(model, tokens, targets, mask)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=tol["logits"],
                               rtol=tol["logits"])
    np.testing.assert_allclose(loss.item(), float(jloss), atol=tol["loss"],
                               rtol=tol["loss"])
    want = params_from_flax(jax.device_get(jgrads), cfg)
    assert set(want) == set(grads)
    for name, w in want.items():
        scale = max(float(np.abs(w.numpy()).max()), 1e-3)
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(),
                                   atol=tol["grad"] * scale,
                                   rtol=tol["grad"], err_msg=name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_bert_logits_loss_and_gradients_match_flax(impl, dtype):
    jmodel, params, model, cfg, tokens, targets, _ = _setup(impl, dtype)
    assert not cfg.causal and not cfg.use_rope
    _check_against_flax(jmodel, params, model, cfg, tokens, targets, None,
                        TOL[dtype])


@pytest.mark.parametrize("bert", [True, False], ids=["bert", "lm"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_padding_mask_matches_flax(dtype, bert):
    # A right-padded batch through the einsum path (after the causal mask
    # for the LM), against the JAX model given the same mask.
    jmodel, params, model, cfg, tokens, targets, mask = _setup(
        "einsum", dtype, bert=bert)
    _check_against_flax(jmodel, params, model, cfg, tokens, targets, mask,
                        TOL[dtype])


def test_padded_row_equals_the_row_cut_to_its_length():
    # The witness chip_smoke.py's [bertmodel] uses on the card, without
    # JAX: the logits at a kept position of a padded row are those of the
    # same row cut to its length.
    _, _, model, _, tokens, _, mask = _setup("einsum", "fp32")
    n = LENGTHS[1]
    with torch.no_grad():
        padded = model(torch.as_tensor(tokens), torch.as_tensor(mask))
        cut = model(torch.as_tensor(tokens[1:, :n]))
    np.testing.assert_allclose(padded[1, :n].numpy(), cut[0].numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("remat", [True, "full", "dots"])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_remat_matches_flax_and_no_remat(impl, remat):
    mask = impl == "einsum"
    jmodel, params, model, cfg, tokens, targets, pad = _setup(
        impl, "fp32", remat=remat)
    pad = pad if mask else None
    _check_against_flax(jmodel, params, model, cfg, tokens, targets, pad,
                        TOL["fp32"])
    _, _, plain, _, _, _, _ = _setup(impl, "fp32")
    got = _torch_run(model, tokens, targets, pad)
    want = _torch_run(plain, tokens, targets, pad)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(got[2][n], want[2][n]) for n in want[2])


def test_remat_runs_the_flash_forward_again_in_the_backward():
    from horovod_tpu_torch.ops import flash_attention as fa
    counts = {}
    for remat in (False, True, "dots"):
        _, _, model, _, tokens, targets, _ = _setup("flash", "fp32",
                                                    remat=remat)
        calls = []
        orig = fa.attention_fwd_plain

        def counted(*a, **k):
            calls.append(1)
            return orig(*a, **k)
        fa.attention_fwd_plain = counted
        try:
            _torch_run(model, tokens, targets)
        finally:
            fa.attention_fwd_plain = orig
        counts[remat] = len(calls)
    assert counts == {False: SMALL["layers"], True: 2 * SMALL["layers"],
                      "dots": 2 * SMALL["layers"]}


def test_dots_policy_keeps_the_dense_projections_only():
    # JAX's dots_with_no_batch_dims_saveable: a dot_general without batch
    # dimensions is saved (the dense layers: aten mm/addmm on the
    # flattened rows), one with batch dimensions is not (bmm).
    from torch.utils.checkpoint import CheckpointPolicy
    from horovod_tpu_torch.models import _remat
    aten = torch.ops.aten
    assert _remat._dots_policy(None, aten.addmm.default) == \
        CheckpointPolicy.MUST_SAVE
    assert _remat._dots_policy(None, aten.mm.default) == \
        CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.convolution.default,
               aten.gelu.default, aten.native_layer_norm.default):
        assert _remat._dots_policy(None, op) == \
            CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError, match="remat"):
        BertModel(BertConfig(**SMALL, remat="everything"))


@pytest.mark.parametrize("bert", [True, False], ids=["bert", "lm"])
def test_flash_with_a_mask_raises(bert):
    _, _, model, _, tokens, _, mask = _setup("flash", "fp32", bert=bert)
    with pytest.raises(ValueError, match="padding masks"):
        model(torch.as_tensor(tokens), torch.as_tensor(mask))


def test_bert_config_is_bert_large():
    cfg = BertConfig()
    jcfg = JBertConfig()
    for field in ("vocab_size", "hidden", "layers", "heads", "mlp_ratio",
                  "max_len", "causal", "use_rope", "remat"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert (cfg.vocab_size, cfg.hidden, cfg.layers, cfg.heads, cfg.max_len,
            cfg.causal, cfg.use_rope) == (30522, 1024, 24, 16, 512, False,
                                          False)
    assert BertConfig(attention_impl="flash").attention_impl == "flash"


def test_params_from_flax_maps_the_whole_bert_tree():
    jmodel, params, model, cfg, _, _, _ = _setup()
    sd = params_from_flax(jax.device_get(params), cfg)
    assert set(sd) == set(model.state_dict())
    n_flax = sum(np.asarray(x).size for x in
                 jax.tree_util.tree_leaves(params))
    assert sum(v.numel() for v in sd.values()) == n_flax
