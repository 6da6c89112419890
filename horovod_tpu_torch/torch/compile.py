"""The torch bridge on CUDA: ``tpu_compile`` (port of
``horovod_tpu/torch/compile.py``).

The JAX package traces a torch module with ``torch.fx`` and lowers the graph
to JAX, so that the math runs on the TPU. On a GPU the module runs natively,
so there is no trace and no lowering. What the port keeps is the bridge's
contract:

- the entry point and its result, a :class:`CompiledModule` with fp32
  master weights (``params``), a functional ``apply``, ``__call__``,
  ``loss_fn``, ``make_train_step`` and ``copy_params_to_module``;
- mixed precision: ``compute_dtype`` casts the float parameters on entry,
  so gradients land in the fp32 masters, while cross-entropy computes in
  fp32 as the JAX lowering does (torch's LayerNorm and softmax compute
  bf16 inputs in fp32 already);
- attention routing: while the module runs, a ``TorchFunctionMode`` sends
  ``F.scaled_dot_product_attention`` to the repo's flash kernels (with
  attention dropout as an explicit keep-mask or a Philox seed). A call
  with an ``attn_mask`` (a padded batch) takes the einsum lowering, as the
  JAX bridge does with a mask that is not a compile-time constant: on
  CUDA tensors always (the mask is never read on the host), on CPU tensors
  unless the mask keeps every position. A user whose mask keeps every
  position gets the kernels by passing ``attn_mask=None``. On CUDA tensors
  a call the kernels cannot take for its shapes (a head dim above 128)
  raises; on CPU tensors it takes the einsum lowering. Either fallback
  warns once;
- explicit randomness: ``rng`` is an int seed, the counterpart of the JAX
  key. One seed gives the same dropout patterns on every run.

    compiled = tpu_compile(model, compute_dtype=torch.bfloat16)
    opt = torch.optim.AdamW(compiled.params.values(), lr=1e-4)
    step = compiled.make_train_step(opt)
    for i, batch in enumerate(batches):
        loss = step(batch, rng=i)      # a new seed each step
    compiled.copy_params_to_module(model)

Nothing here makes the host wait for the device: the per-site Philox seeds
come from a host generator, the keep-masks from a device generator.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from .. import basics
from ..ops import flash_attention as fa
from ..utils import envparse


def dropout_mode(on_cuda):
    """``"mask"`` or ``"seed"``: how the flash path draws attention dropout.
    On the CPU, where the plain versions run the test suite, an explicit
    keep-mask, as the JAX bridge's rule off the TPU. On CUDA tensors a
    Philox seed, unless ``HVDTPU_FLASH_DROPOUT=mask`` (``auto`` and ``prng``
    take the seed). The JAX bridge's ``auto`` keeps the mask up to
    ``HVDTPU_FLASH_DROPOUT_MASK_LIMIT``, as measured faster on a TPU; on an
    H100 the seeded BERT-large step takes less device time and holds no
    masks (chip_smoke.py's ``[bert-ab]``)."""
    if not on_cuda:
        return "mask"
    mode = envparse.get_str(envparse.FLASH_DROPOUT, "auto").lower()
    return "mask" if mode == "mask" else "seed"


class _StepRandomness:
    """The randomness of one forward: the keep-masks from a device
    generator and the per-site Philox seeds from a host generator, both
    seeded from ``seed`` and drawn in site order."""

    def __init__(self, seed, generator):
        self.device_gen = generator
        self.device_gen.manual_seed(seed)
        self.host_gen = np.random.default_rng(seed)

    def keep_mask(self, shape, rate, device):
        return torch.rand(shape, generator=self.device_gen,
                          device=device) < (1.0 - rate)

    def seed(self):
        return int(self.host_gen.integers(0, 2 ** 32))


def _resolve_static_mask(attn_mask):
    """None when ``attn_mask`` keeps every position, else the mask. Only a
    CPU mask is inspected: reading a CUDA one would make the host wait for
    the device at every attention site, so any CUDA mask counts as not
    statically all-keep."""
    if attn_mask is None or attn_mask.is_cuda:
        return attn_mask
    if attn_mask.dtype == torch.bool:
        return None if bool(attn_mask.all()) else attn_mask
    return None if bool((attn_mask == 0).all()) else attn_mask


def _dropout(x, p, rand):
    """The einsum lowering's attention dropout (``_dropout`` of the JAX
    bridge): the same keep-mask draw as the flash path's mask mode."""
    if rand is None or not p:
        return x
    keep = rand.keep_mask(x.shape, float(p), x.device)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _shapes_unsupported(q, k, v):
    """Why the flash kernels cannot take these q/k/v, or None: they take
    4-D q/k/v of one batch and head count and equal head dims up to
    128."""
    if not (q.dim() == k.dim() == v.dim() == 4
            and q.shape[:2] == k.shape[:2] == v.shape[:2]
            and q.shape[-1] == k.shape[-1] == v.shape[-1]
            and q.shape[-1] <= 128):
        return (f"q/k/v shapes {tuple(q.shape)}/{tuple(k.shape)}/"
                f"{tuple(v.shape)}")
    return None


def _mask_unsupported(attn_mask):
    """Why ``attn_mask`` keeps the call off the kernels, or None: any mask
    but a CPU one that keeps every position (which is dropped)."""
    if _resolve_static_mask(attn_mask) is None:
        return None
    return (f"mask is not statically all-keep: {attn_mask.dtype} "
            f"attn_mask of shape {tuple(attn_mask.shape)}")


def _sdpa(rand, query, key, value, attn_mask=None, dropout_p=0.0,
          is_causal=False, scale=None):
    """``F.scaled_dot_product_attention`` semantics (bool masks keep where
    True, float masks add). A call with a mask takes the einsum lowering
    (on CUDA tensors whatever the mask holds: it is never read on the
    host). Else CUDA tensors run on the flash kernels, and q/k/v they
    cannot take raise; CPU tensors take the kernels' plain versions where
    ``HVDTPU_BRIDGE_FLASH`` asks for them and the call fits, else the
    einsum lowering. A call that does not fit warns once per reason.
    ``rand`` is None outside training: then there is no dropout."""
    q, k, v = query, key, value
    bad_shapes = _shapes_unsupported(q, k, v)
    if q.is_cuda and bad_shapes:
        raise NotImplementedError(
            f"tpu_compile: the flash kernels cannot take this attention call "
            f"({bad_shapes}); on CUDA tensors they need 4-D q/k/v with "
            f"equal head dims up to 128")
    unsupported = bad_shapes or _mask_unsupported(attn_mask)
    if not unsupported and fa.bridge_flash_enabled(q.device):
        dm = seed = None
        rate = 0.0
        if dropout_p and rand is not None:
            rate = float(dropout_p)
            if dropout_mode(q.is_cuda) == "mask":
                dm = rand.keep_mask(q.shape[:3] + (k.shape[2],), rate,
                                    q.device)
            else:
                seed = rand.seed()
        return fa.flash_attention(
            q, k, v, causal=bool(is_causal), sm_scale=scale,
            dropout_mask=dm, dropout_rate=rate, dropout_seed=seed)
    if unsupported:
        fa.note_flash_fallback(unsupported)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            s = torch.where(attn_mask, s, -1e30)
        else:
            s = s + attn_mask.float()
    if is_causal:
        causal = torch.ones(q.shape[-2], k.shape[-2], dtype=torch.bool,
                            device=q.device).tril()
        s = torch.where(causal, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    p = _dropout(p, dropout_p, rand)
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)


class _BridgeMode(TorchFunctionMode):
    """Routes the calls the JAX bridge lowers on its own while a module
    runs: attention to :func:`_sdpa`, and cross-entropy to fp32 logits, so
    that a bf16 run's loss is fp32 as the JAX lowering's is. LayerNorm and
    softmax need no rerouting: torch's own kernels compute bf16 and fp16
    inputs in fp32 and round once, as the JAX lowerings do."""

    def __init__(self, rand):
        super().__init__()
        self.rand = rand

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.scaled_dot_product_attention:
            return _sdpa(self.rand, *args, **kwargs)
        if func is F.cross_entropy:
            logits, *rest = args
            return func(logits.float(), *rest, **kwargs)
        return func(*args, **kwargs)


def _fold(seed, rank):
    """A per-rank seed from a user seed (the JAX step's fold_in of the
    rank), so that ranks draw different dropout patterns."""
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1, np.uint64)[0] >> 1)


class CompiledModule:
    """A torch module run through the bridge: fp32 master weights
    ``params`` (a name -> tensor dict on the runtime's device; tied
    weights are one entry) and the module's own code."""

    def __init__(self, module, params, buffers, device, loss_key="loss",
                 compute_dtype=None):
        self.module = module
        self.params = params
        self.buffers = buffers
        self.device = device
        self.loss_key = loss_key
        self.compute_dtype = compute_dtype
        self._generator = None

    def _randomness(self, rng):
        if rng is None:
            return None
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        return _StepRandomness(int(rng), self._generator)

    def apply(self, params, inputs, rng=None, train=False):
        """The module's forward on ``inputs`` (a dict of keyword
        arguments) with ``params``, differentiable with respect to them.

        With ``compute_dtype`` set, float params are cast on entry: master
        weights and gradients stay fp32, the matmuls run in the compute
        type. ``rng`` (an int) seeds every dropout site of this call; with
        ``train`` and no ``rng`` there is no dropout, as in the JAX bridge.
        """
        if self.compute_dtype is not None:
            params = {k: (v.to(self.compute_dtype)
                          if v.is_floating_point() else v)
                      for k, v in params.items()}
        train = bool(train)
        rand = self._randomness(rng) if train else None
        was_training = self.module.training
        self.module.train(train and rand is not None)
        devices = [self.device] if self.device.type == "cuda" else []
        try:
            with torch.random.fork_rng(devices=devices,
                                       enabled=rand is not None), \
                    _BridgeMode(rand):
                # nn.Dropout on hidden states draws from the global
                # generators, seeded here from the same seed.
                if rand is not None:
                    torch.random.default_generator.manual_seed(int(rng))
                    if devices:
                        with torch.cuda.device(self.device):
                            torch.cuda.manual_seed(int(rng))
                return torch.func.functional_call(
                    self.module, {**self.buffers, **params}, (),
                    {k: self._coerce(v) for k, v in inputs.items()})
        finally:
            self.module.train(was_training)

    def _coerce(self, v):
        return v.to(self.device) if isinstance(v, torch.Tensor) else v

    def __call__(self, rng=None, train=False, **inputs):
        """Forward without gradients; ``rng`` and ``train`` as for
        :meth:`apply`."""
        with torch.no_grad():
            return self.apply(self.params, inputs, rng=rng, train=train)

    def loss_fn(self):
        """(params, batch, rng) -> scalar loss in train mode; ``batch`` is
        the inputs dict and the output must carry ``loss_key``."""
        def fn(params, batch, rng=None):
            out = self.apply(params, batch, rng=rng, train=True)
            if isinstance(out, dict):
                return out[self.loss_key]
            return getattr(out, self.loss_key)
        return fn

    def make_train_step(self, optimizer, process_set=None):
        """``step(batch, rng=None) -> loss``: forward and backward on this
        rank's batch, gradients averaged across ranks, the optimizer's
        update of ``params``; the loss averaged across ranks. A bare
        ``torch.optim.Optimizer`` (built over ``params.values()``) is
        wrapped in :class:`~horovod_tpu_torch.train.DistributedOptimizer`.
        The rank is folded into ``rng``, so each rank drops its own
        elements."""
        from .. import train
        dist_opt = optimizer
        if not hasattr(dist_opt, "inner"):
            dist_opt = train.DistributedOptimizer(
                optimizer, **({"process_set": process_set}
                              if process_set else {}))
        owned = {id(p) for g in dist_opt.inner.param_groups
                 for p in g["params"]}
        if owned != {id(p) for p in self.params.values()}:
            raise ValueError(
                "make_train_step: the optimizer must be built over this "
                "CompiledModule's params.values()")
        loss = self.loss_fn()
        inner = train.make_train_step(
            lambda _, b: loss(self.params, b[0], rng=b[1]), dist_opt)

        def step(batch, rng=None):
            if rng is not None:
                rng = _fold(rng, basics.rank())
            return inner(None, (batch, rng))
        return step

    def copy_params_to_module(self, module):
        """Write the (possibly trained) parameters back into ``module``,
        so that torch-side checkpointing and evaluation see them."""
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name in self.params:
                    p.copy_(self.params[name].to(p.dtype))


def _device():
    if basics.is_initialized():
        return basics.device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_compile: no CUDA device is available and the runtime is "
            "not initialised; call horovod_tpu_torch.init(device='cpu') to "
            "run on the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def tpu_compile(module, input_names=None, example_inputs=None,
                loss_key="loss", compute_dtype=None, verify=False):
    """Wrap a torch module for training through the bridge; returns a
    :class:`CompiledModule` whose parameters live on the runtime's device
    (``horovod_tpu_torch.init()``'s; the current CUDA device if the runtime
    is not initialised).

    The name and signature are the JAX package's, which user scripts call
    as ``hvd.tpu_compile``. ``input_names`` and ``example_inputs`` are
    accepted and have no effect: they specialise the JAX package's fx trace,
    and on CUDA the module runs as it is, with nothing traced. ``verify``
    (the hvd-lint analyzer of the traced program) is not ported; the
    offline analyzer (``python -m horovod_tpu_torch.analysis.cli``) is.
    """
    del input_names, example_inputs
    if verify is not False:
        raise NotImplementedError(
            "tpu_compile(verify=...): the traced-program collective "
            "analyzer (the torch.fx counterpart of the JAX package's "
            "jaxpr_lint) is not ported yet (ROADMAP queue A, item 15)")
    device = _device()
    # named_parameters() lists a tied tensor once, under its first name;
    # functional_call keeps the tie, so it stays one trainable leaf.
    params = {n: p.detach().to(device=device, dtype=torch.float32)
              .clone().requires_grad_()
              for n, p in module.named_parameters()}
    buffers = {n: b.to(device) for n, b in module.named_buffers()}
    return CompiledModule(module, params, buffers, device, loss_key=loss_key,
                          compute_dtype=compute_dtype)
