"""Program executors (port of ``horovod_tpu/resharding/execute.py``):
host-side windowed copies, a one-axis executor over a process group, and
the group executor.

The host executor is the elastic / train→serve path: it assembles each
destination rank's local buffers by reading bounded windows of the
source shards — ``read_window(src_rank, buf_key, start, length)`` is
the only way source data enters, so a fully-replicated leaf is never
materialized. Peak live bytes per destination rank stay within its
local buffers (≤ one shard) plus the in-flight window (≤ the bucket
budget) plus one source-side staging window — the shard + 2×bucket
bound the property tests pin through :class:`MemoryLedger`.

Where the JAX package runs one process over many devices and reads any
device's "addressable shards", a job of the port holds one rank per
process: a rank reads only its own source buffers and gets the rest over
``torch.distributed`` (NCCL on CUDA tensors, gloo on CPU ones).

- :func:`make_jit_executor` is the counterpart of the JAX package's
  shard_map executor (same signature and refusals: one axis, the same
  mesh on both sides, no pending sum, one dtype): each ``Step`` is one
  ``all_to_all_single`` over the axis's group, its split sizes from the
  step's copies, or a local copy for a ``slice`` step.
- :func:`execute_group` runs any program — mixed dtypes, a destination
  mesh smaller or larger than the source, pending sums — over a group
  that holds both cohorts (group rank r is source rank r and destination
  rank r). Each comm step is one ``all_to_all_single`` of byte views;
  ``sum`` steps add on the receiving side in the order the host executor
  adds, so the results are the host executor's to the bit.

Telemetry: ``hvd_reshard_bytes_total{leg}``, ``hvd_reshard_seconds``,
``hvd_reshard_peak_bytes``.
"""

import time

import torch
import torch.distributed as dist

from .spec import torch_dtype


def _m_bytes():
    from ..telemetry import core as telemetry
    return telemetry.counter(
        "hvd_reshard_bytes_total",
        "Bytes moved by redistribution programs, per leg kind",
        ("leg",))


def _m_seconds():
    from ..telemetry import core as telemetry
    return telemetry.histogram(
        "hvd_reshard_seconds",
        "Wall time of one redistribution program execution")


def _m_peak():
    from ..telemetry import core as telemetry
    return telemetry.gauge(
        "hvd_reshard_peak_bytes",
        "Peak live scratch+destination bytes of the last program "
        "execution (bounded by shard + 2x HVDTPU_RESHARD_BUCKET_BYTES)")


def _span():
    from ..telemetry import span
    return span(["resharding"], "RESHARD_EXECUTE", histogram=_m_seconds())


class MemoryLedger:
    """Counting allocator shim: every buffer the executors hold is
    accounted here, so tests assert the memory bound instead of trusting
    it."""

    __slots__ = ("live", "peak")

    def __init__(self):
        self.live = 0
        self.peak = 0

    def alloc(self, nbytes):
        self.live += int(nbytes)
        if self.live > self.peak:
            self.peak = self.live

    def free(self, nbytes):
        self.live -= int(nbytes)


def _nbytes(t):
    return t.numel() * t.element_size()


def _window(read_window, rank, buf, start, length):
    return torch.as_tensor(read_window(rank, buf, start, length)).reshape(-1)


def execute_host(program, read_window, ranks=None, dtype_override=None,
                 ledger=None, device=None):
    """Run ``program`` in this process for the given destination ranks
    (default: all). Returns ``(results, report)`` where ``results`` maps
    ``dst_rank -> {buf_key: 1-D tensor}`` (on ``device``, the CPU by
    default) and ``report`` carries ``peak_bytes`` (max over ranks of
    buffers + in-flight windows), per-leg byte counts, and the program's
    predicted cost.

    ``read_window(src_rank, buf_key, start, length)`` must return the
    1-D window of that source buffer (a tensor or a numpy array) — and
    must itself stay windowed (read a shard, slice a bucket) for the
    memory bound to hold end-to-end. ``dtype_override`` reinterprets
    every destination buffer's dtype (the optimizer-moment path reuses
    one geometry for f32 moment slots over non-f32 params)."""
    ledger = ledger if ledger is not None else MemoryLedger()
    dst, meta = program.dst, program.tree_meta
    if ranks is None:
        ranks = range(dst.world)
    results, peak_overall = {}, 0
    bytes_by_leg = {}
    with _span():
        for rank in ranks:
            base = ledger.live
            rank_peak = 0
            bufs = {}
            for key, (n, dt) in dst.local_buffers(meta, rank).items():
                bufs[key] = torch.zeros(
                    n, dtype=torch_dtype(dtype_override or dt),
                    device=device)
                ledger.alloc(_nbytes(bufs[key]))
            rank_peak = max(rank_peak, ledger.live - base)
            for step in program.steps:
                moved = 0
                for c in step.copies:
                    if c.dst_rank != rank:
                        continue
                    win = _window(read_window, c.src_rank, c.src_buf,
                                  c.src_off, c.length)
                    ledger.alloc(_nbytes(win))
                    rank_peak = max(rank_peak, ledger.live - base)
                    out = bufs[c.dst_buf]
                    sl = slice(c.dst_off, c.dst_off + c.length)
                    win_out = win.to(device=out.device, dtype=out.dtype)
                    if step.op == "sum":
                        out[sl] += win_out
                    else:
                        out[sl] = win_out
                    ledger.free(_nbytes(win))
                    moved += _nbytes(win)
                if moved:
                    bytes_by_leg[step.kind] = \
                        bytes_by_leg.get(step.kind, 0) + moved
                    _m_bytes().labels(leg=step.kind).inc(moved)
            results[rank] = bufs
            peak_overall = max(peak_overall, rank_peak)
            # Hand the rank's buffers to the caller: they leave the
            # executor's accounting (the bound is per-rank scratch,
            # not the caller's aggregate).
            for arr in bufs.values():
                ledger.free(_nbytes(arr))
    _m_peak().set(peak_overall)
    report = {
        "strategy": program.strategy,
        "predicted_s": program.predicted_s,
        "peak_bytes": peak_overall,
        "bytes_by_leg": bytes_by_leg,
        "wire_bytes": program.bytes_moved(),
    }
    return results, report


def buffers_of_tree(spec, tree_meta, leaves, rank, device=None):
    """Materialize ``rank``'s local buffers under ``spec`` from full
    leaves (tensors or numpy arrays) — the test/bench helper for seeding
    a source side. Uses ownership intervals, so it works for any
    layout."""
    own = spec.ownership(tree_meta, rank)
    bufs = {key: torch.zeros(n, dtype=torch_dtype(dt), device=device)
            for key, (n, dt) in
            spec.local_buffers(tree_meta, rank).items()}
    for i, ivs in enumerate(own):
        flat = torch.as_tensor(leaves[i]).reshape(-1)
        for iv in ivs:
            bufs[iv.buf][iv.b0:iv.b0 + iv.length] = \
                flat[iv.g0:iv.g0 + iv.length]
    return bufs


def reader_for_buffers(buffers):
    """``read_window`` over ``{rank: {buf_key: tensor}}`` that slices —
    never copies whole buffers beyond the requested window."""
    def read_window(rank, buf, start, length):
        return buffers[rank][buf][start:start + length]
    return read_window


# ==========================================================================
# One axis of a mesh, over its process group
# ==========================================================================

def _axis_group(mesh, axis_name):
    """The process group of ``axis_name``: a dimension of a ``DeviceMesh``
    (or the group itself when ``mesh`` is a ``ProcessGroup``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return mesh
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes "
                         f"{list(names)})")
    return mesh.get_group(axis_name)


def _flat_layout(spec, tree_meta):
    """buf_key -> offset in the rank's concatenated local flat buffer
    (uniform across ranks — required for one program on every rank)."""
    sizes = {}
    for r in range(spec.world):
        bufs = spec.local_buffers(tree_meta, r)
        for key, (nelem, _) in bufs.items():
            if key in sizes and sizes[key] != nelem:
                raise NotImplementedError(
                    "one-axis execution requires uniform per-rank buffer "
                    f"sizes; {key} varies across ranks (near-even "
                    "sharding) — use execute_group")
            sizes[key] = nelem
    layout, off = {}, 0
    for key in sorted(sizes):
        layout[key] = off
        off += sizes[key]
    return layout, off


def _rank_maps(program, n, me, src_layout, dst_layout):
    """This rank's part of every step: ``("slice", gather, scatter)`` or
    ``(kind, send, send_splits, recv_scatter, recv_splits)`` as index
    lists into the concatenated flat buffers; copies in the JAX package's
    order (source, destination, destination buffer and offset)."""
    def rng(layout, buf, off, length):
        return range(layout[buf] + off, layout[buf] + off + length)

    maps = []
    for step in program.steps:
        if step.kind == "slice":
            gidx, sidx = [], []
            for c in step.copies:
                if c.dst_rank == me:
                    gidx += rng(src_layout, c.src_buf, c.src_off, c.length)
                    sidx += rng(dst_layout, c.dst_buf, c.dst_off, c.length)
            maps.append(("slice", gidx, sidx))
            continue
        send, send_splits = [], [0] * n
        recv, recv_splits = [], [0] * n
        for c in sorted(step.copies, key=lambda c: (
                c.src_rank, c.dst_rank, c.dst_buf, c.dst_off)):
            if c.src_rank == me:
                send += rng(src_layout, c.src_buf, c.src_off, c.length)
                send_splits[c.dst_rank] += c.length
            if c.dst_rank == me:
                recv += rng(dst_layout, c.dst_buf, c.dst_off, c.length)
                recv_splits[c.src_rank] += c.length
        maps.append((step.kind, send, send_splits, recv, recv_splits))
    return maps


def make_jit_executor(program, mesh, axis_name):
    """Bind ``program`` (the same single-axis mesh on both sides, no
    pending-sum legs, one dtype) to the process group of ``axis_name``
    (a dimension of a ``DeviceMesh``, or ``mesh`` itself when it is a
    ``ProcessGroup``). Returns ``fn(in_bufs) -> out_bufs`` over THIS
    rank's local buffers: ``in_bufs`` / ``out_bufs`` are dicts keyed like
    the spec's local buffers, each a 1-D tensor of the rank's local
    length (the rank-r block of the JAX executor's global arrays). Every
    rank of the group calls ``fn`` together."""
    group = _axis_group(mesh, axis_name)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    for side, name in ((program.src, "src"), (program.dst, "dst")):
        if side.mesh_signature() != [[axis_name, n]]:
            raise NotImplementedError(
                f"in-jit execution supports single-axis same-mesh "
                f"programs; {name} mesh is {side.mesh_signature()}, "
                f"executor axis is [[{axis_name!r}, {n}]]")
    if any(s.op == "sum" for s in program.steps):
        raise NotImplementedError(
            "pending-sum (reduce-scatter) programs are host-path "
            "only for now")
    meta = program.tree_meta
    if len({dt for _, dt in meta}) > 1:
        raise NotImplementedError(
            "in-jit execution requires a uniform leaf dtype (the "
            "buffers ride one concatenated flat vector); mixed-dtype "
            "trees take execute_host or execute_group")
    src_layout, _ = _flat_layout(program.src, meta)
    dst_layout, total_out = _flat_layout(program.dst, meta)
    src_keys, dst_keys = sorted(src_layout), sorted(dst_layout)
    dst_sizes = {k: program.dst.local_buffers(meta, 0)[k][0]
                 for k in dst_keys}
    maps = _rank_maps(program, n, me, src_layout, dst_layout)
    dtype = torch_dtype(meta[0][1]) if meta else torch.float32
    cache = {}

    def index(dev):
        """The maps with their index lists as tensors on ``dev``."""
        if dev not in cache:
            def t(x):
                return torch.tensor(x, dtype=torch.int64, device=dev)
            cache[dev] = [
                ("slice", t(m[1]), t(m[2])) if m[0] == "slice"
                else (m[0], t(m[1]), m[2], t(m[3]), m[4]) for m in maps]
        return cache[dev]

    def run(in_bufs):
        flats = [in_bufs[k].reshape(-1) for k in src_keys]
        dev = flats[0].device if flats else torch.device("cpu")
        flat_in = torch.cat(flats) if flats else \
            torch.zeros(0, dtype=dtype, device=dev)
        flat_out = torch.zeros(total_out, dtype=flat_in.dtype, device=dev)
        for m in index(dev):
            if m[0] == "slice":
                _, gidx, sidx = m
                flat_out[sidx] = flat_in[gidx]
                continue
            _, send, send_splits, recv_idx, recv_splits = m
            recv = torch.empty(sum(recv_splits), dtype=flat_in.dtype,
                               device=dev)
            dist.all_to_all_single(recv, flat_in[send].contiguous(),
                                   recv_splits, send_splits, group=group)
            flat_out[recv_idx] = recv
        outs, off = {}, 0
        for k in dst_keys:
            outs[k] = flat_out[off:off + dst_sizes[k]]
            off += dst_sizes[k]
        return outs

    return run


# ==========================================================================
# Any program over a group holding both cohorts
# ==========================================================================

_ALIGN = 16   # byte offset of every window in a step's payload


def _align(n):
    return -(-n // _ALIGN) * _ALIGN


def _default_device(group):
    if "nccl" in str(dist.get_backend(group)):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def execute_group(program, read_window, group=None, dtype_override=None,
                  ledger=None, device=None):
    """Run ``program`` over ``group`` (default: the world group), which
    holds both cohorts: group rank r is source rank r (for r below the
    source world) and destination rank r (below the destination world).
    Every rank of the group calls it together.

    ``read_window(src_rank, buf_key, start, length)`` is asked only for
    this rank's own source buffers. Windows bound for another rank are
    cast to the destination buffer's dtype, packed as bytes and moved by
    one ``all_to_all_single`` per comm step; ``slice`` steps and copies a
    rank makes to itself stay local. Returns ``(bufs, report)``: this
    rank's destination buffers ``{buf_key: 1-D tensor}`` on ``device``
    (the group's device by default; empty when the rank is not in the
    destination cohort) and ``peak_bytes`` (its buffers plus a step's
    send and receive payloads), ``bytes_by_leg`` (bytes it placed),
    ``sent_bytes``, ``wire_bytes`` (the program's) and ``seconds``."""
    group = group if group is not None else dist.group.WORLD
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    src, dst, meta = program.src, program.dst, program.tree_meta
    if n < max(src.world, dst.world):
        raise ValueError(
            f"execute_group: the group has {n} ranks; the program's "
            f"cohorts need {max(src.world, dst.world)} (source "
            f"{src.world}, destination {dst.world})")
    device = torch.device(device) if device is not None \
        else _default_device(group)
    ledger = ledger if ledger is not None else MemoryLedger()
    dst_dtypes = {}

    def out_dtype(rank, buf):
        if (rank, buf) not in dst_dtypes:
            for key, (_, dt) in dst.local_buffers(meta, rank).items():
                dst_dtypes[(rank, key)] = torch_dtype(dtype_override or dt)
        return dst_dtypes[(rank, buf)]

    t0 = time.perf_counter()
    bufs = {}
    if me < dst.world:
        for key, (nelem, dt) in dst.local_buffers(meta, me).items():
            bufs[key] = torch.zeros(
                nelem, dtype=torch_dtype(dtype_override or dt),
                device=device)
            ledger.alloc(_nbytes(bufs[key]))
    base_peak = ledger.live
    peak = base_peak
    bytes_by_leg, sent = {}, 0
    with _span():
        for step in program.steps:
            remote = [c for c in step.copies if c.src_rank != c.dst_rank]
            mine_in = [c for c in step.copies if c.dst_rank == me]
            recv_at, recv = {}, None
            if remote:
                # this rank's payload per destination, windows aligned
                send_off, send_splits = [], [0] * n
                for c in sorted(remote, key=lambda c: c.dst_rank):
                    if c.src_rank != me:
                        continue
                    size = c.length * out_dtype(
                        c.dst_rank, c.dst_buf).itemsize
                    send_off.append((c, sum(send_splits)))
                    send_splits[c.dst_rank] += _align(size)
                recv_splits = [0] * n
                for c in sorted(remote, key=lambda c: c.src_rank):
                    if c.dst_rank != me:
                        continue
                    dt = out_dtype(me, c.dst_buf)
                    recv_at[id(c)] = (sum(recv_splits), dt)
                    recv_splits[c.src_rank] += _align(c.length * dt.itemsize)
                payload = torch.zeros(sum(send_splits), dtype=torch.uint8,
                                      device=device)
                for c, off in send_off:
                    win = _window(read_window, me, c.src_buf, c.src_off,
                                  c.length).to(
                        device=device,
                        dtype=out_dtype(c.dst_rank, c.dst_buf))
                    raw = win.view(torch.uint8)
                    payload[off:off + raw.numel()] = raw
                recv = torch.empty(sum(recv_splits), dtype=torch.uint8,
                                   device=device)
                ledger.alloc(payload.numel() + recv.numel())
                peak = max(peak, ledger.live)
                dist.all_to_all_single(recv, payload, recv_splits,
                                       send_splits, group=group)
                sent += payload.numel()
                ledger.free(payload.numel())
                del payload
            moved = 0
            for c in mine_in:
                out = bufs[c.dst_buf]
                if c.src_rank == me:
                    win = _window(read_window, me, c.src_buf, c.src_off,
                                  c.length).to(device=device,
                                               dtype=out.dtype)
                    ledger.alloc(_nbytes(win))
                    peak = max(peak, ledger.live)
                    ledger.free(_nbytes(win))
                else:
                    off, dt = recv_at[id(c)]
                    win = recv[off:off + c.length * dt.itemsize].view(dt)
                sl = slice(c.dst_off, c.dst_off + c.length)
                if step.op == "sum":
                    out[sl] += win
                else:
                    out[sl] = win
                moved += _nbytes(win)
            if recv is not None:
                ledger.free(recv.numel())
            if moved:
                bytes_by_leg[step.kind] = bytes_by_leg.get(step.kind, 0) \
                    + moved
                _m_bytes().labels(leg=step.kind).inc(moved)
    for arr in bufs.values():
        ledger.free(_nbytes(arr))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    _m_peak().set(peak)
    return bufs, {
        "strategy": program.strategy,
        "predicted_s": program.predicted_s,
        "peak_bytes": peak,
        "bytes_by_leg": bytes_by_leg,
        "sent_bytes": sent,
        "wire_bytes": program.bytes_moved(),
        "seconds": time.perf_counter() - t0,
    }
