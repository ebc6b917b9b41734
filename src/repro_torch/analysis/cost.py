"""The port's counterpart of XLA's ``cost_analysis()`` and
``memory_analysis()``, which the reference's dry-run reads from its
compiled SPMD program: :class:`CostMode`, a ``TorchDispatchMode`` over a
step traced on the ``meta`` device (shapes only: nothing is allocated and
no kernel launches).

- **FLOPs** take ``torch.utils.flop_counter``'s formulas for the matmul,
  bmm, convolution and attention ops, applied as ``FlopCounterMode``
  applies them (an op with a decomposition is counted through it); every
  other op counts none.
- **Bytes** count each op's inputs read once and its outputs written
  once; views, aliases and metadata ops cost nothing, and an allocation
  (``empty``) writes nothing. In eager PyTorch this is also what each op
  really moves.
- **A hand-written kernel** is charged by its own work: on ``meta`` its
  wrapper launches nothing and calls ``kernels.charge`` with the bytes
  and operations of the formula kept beside the kernel
  (``kernels.wkv6.wkv6_cost``, ...), the same count as the bounds of
  ``chip_smoke.py``.
- **Peak bytes per device** is the largest live set of any one mesh
  position, argument buffers included, and, while an op runs, the
  scratch its CUDA kernel allocates for itself (``_SCRATCH``: what
  ``experiments/torch_alloc_probe.py`` found on the H100; a shape trace
  cannot see it). Every position of a mesh of
  ``meta`` devices is the same device (``torch.device("meta:3").index``
  is ``None``), so each storage is given owners instead: the positions
  that hold it. ``sharding.place``, ``working_copy``, ``reduce_grads``
  and the collectives name them (``sharding.accounting(tracker=mode)``);
  an op's new outputs take the owners that its owned inputs share (their
  intersection; their union where the inputs of different positions
  meet, inside a collective); a storage made without owned inputs
  (``torch.arange``, ``torch.empty``) or from shared inputs alone (a
  cast of a replicated weight) takes the owners of the first op that uses
  it beside owned ones. A storage is freed when its last tensor dies. A
  trace of one position (``positions`` left out) owns everything.

FLOPs and bytes are summed over all positions; a step's per-device cost
is that total over the number of positions (the SPMD program runs the
same work on each).
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import kernels

_SKIP = {torch.ops.prim.device.default}
#: Allocations: they write nothing.
_ALLOC = {torch.ops.aten.empty.memory_format,
          torch.ops.aten.empty_like.default,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}
#: Ops whose result's elements each take a transcendental function
#: (XLA's ``transcendentals`` count).
_TRANSCENDENTAL = {
    getattr(torch.ops.aten, n).default
    for n in ("exp", "log", "tanh", "sigmoid", "rsqrt", "sqrt", "sin", "cos",
              "erf", "silu", "logsumexp", "_softmax", "gelu")}
#: In-place ops that overwrite their first argument without reading it.
_OVERWRITE = {torch.ops.aten.copy_.default, torch.ops.aten.fill_.Scalar,
              torch.ops.aten.fill_.Tensor, torch.ops.aten.zero_.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sum_scratch(x, dims=None, *rest, **kw) -> int:
    """A CUDA sum that keeps the last dim (a reduction over the leading
    dims) stages a copy of its input."""
    if dims is None:
        return 0
    last = x.dim() - 1
    return 0 if any(d % x.dim() == last for d in dims) else _nbytes(x)


#: Scratch a CUDA kernel allocates inside an op beside its outputs, in
#: bytes, by the op's arguments (measured on the H100 by
#: ``experiments/torch_alloc_probe.py``: 1 GiB in the softmax backward of
#: an attention chunk, 250 MiB in the loss's logsumexp, 132 MiB in a norm
#: scale's gradient sum, at [16a]'s step).
_SCRATCH = {
    torch.ops.aten._softmax_backward_data.default:
        lambda grad, *rest, **kw: _nbytes(grad),
    torch.ops.aten.logsumexp.default: lambda x, *rest, **kw: _nbytes(x),
    torch.ops.aten.sum.dim_IntList: _sum_scratch,
}


def _tensors(args, out: list) -> list:
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            _tensors(a, out)
    return out


class _Store:
    __slots__ = ("nbytes", "owners", "pinned")

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.owners = None        # frozenset of position indices, or None
        self.pinned = False       # owners named by a move, never refined


class CostMode(TorchDispatchMode):
    """Counts a traced step's FLOPs, bytes and each position's live bytes.

    ``positions`` lists the mesh positions (``sharding.positions``);
    without it the trace is of one position. Read after the trace:
    ``flops`` (``matmul_flops`` from the formulas plus the charged
    kernels'), ``bytes``, ``transcendentals`` (elements of exp, log,
    tanh, ... results), ``kernels`` (name -> ``[calls, bytes,
    flops]``), ``peak`` and ``live`` (a list, one a position), ``ops``,
    ``allocated`` (the bytes of every storage made since
    :meth:`mark_arguments`: what a tracker that never frees would call
    the temporaries).
    :meth:`mark_arguments` snapshots the live set as the step's
    arguments and restarts the peaks there; :meth:`memory` gives the
    reference's memory record from them and the step's outputs."""

    def __init__(self, positions=None):
        super().__init__()
        positions = [()] if positions is None else list(positions)
        self.index = {tuple(p): i for i, p in enumerate(positions)}
        n = len(self.index)
        self.n_positions = n
        self._all = frozenset(range(n)) if n == 1 else None
        self.live = [0] * n
        self.peak = [0] * n
        self.arguments = [0] * n
        self._arg_keys = set()
        self.matmul_flops = 0
        self.kernel_flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.kernels: dict = {}
        self.ops = 0
        self.allocated = 0
        self._stores: dict = {}
        self._depth = 0

    # ------------------------------------------------------------ totals
    @property
    def flops(self) -> int:
        return self.matmul_flops + self.kernel_flops

    def _charge(self, name: str, nbytes: int, flops: int) -> None:
        rec = self.kernels.setdefault(name, [0, 0, 0])
        rec[0] += 1
        rec[1] += nbytes
        rec[2] += flops
        self.kernel_flops += flops
        self.bytes += nbytes

    def __enter__(self):
        if self._depth == 0:
            kernels.listen(self._charge)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                kernels.unlisten(self._charge)

    # ------------------------------------------------------------ memory
    def _store(self, t: torch.Tensor, make: bool):
        st = t.untyped_storage()
        key = st._cdata
        rec = self._stores.get(key)
        if rec is None and make:
            rec = self._stores[key] = _Store(st.nbytes())
            weakref.finalize(st, self._free, key)
            if self._all is not None:
                self._move(rec, self._all)
        return rec

    def _free(self, key) -> None:
        rec = self._stores.pop(key, None)
        if rec is not None and rec.owners:
            for i in rec.owners:
                self.live[i] -= rec.nbytes

    def _move(self, rec: _Store, owners) -> None:
        old = rec.owners or frozenset()
        for i in old - owners:
            self.live[i] -= rec.nbytes
        live, peak = self.live, self.peak
        for i in owners - old:
            live[i] += rec.nbytes
            if live[i] > peak[i]:
                peak[i] = live[i]
        rec.owners = owners

    def own(self, t: torch.Tensor, positions) -> None:
        """``positions`` (mesh positions) own ``t``'s storage, for good."""
        rec = self._store(t, True)
        self._move(rec, frozenset(self.index[tuple(p)] for p in positions))
        rec.pinned = True

    def share(self, outs, ins) -> None:
        """Each output belongs to the owners of its input (outputs that
        are one storage to the union of theirs)."""
        acc: dict = {}
        for o, i in zip(outs, ins):
            rec = self._store(i, False)
            if rec is None or not rec.owners:
                continue
            key = o.untyped_storage()._cdata
            acc[key] = (o, acc.get(key, (o, frozenset()))[1] | rec.owners)
        for o, owners in acc.values():
            rec = self._store(o, True)
            self._move(rec, owners)
            rec.pinned = True

    def mark_arguments(self) -> None:
        """The live set now is the step's arguments; peaks restart here."""
        self.arguments = list(self.live)
        self.peak = list(self.live)
        self.allocated = 0
        self._arg_keys = set(self._stores)

    def memory(self, outputs) -> dict:
        """The reference's memory record (bytes, one device: the position
        of the largest peak) for a step whose results are ``outputs``
        (any nesting of dicts, lists, tuples and tensors; ``Sharded``
        leaves by their pieces): ``argument``, ``output``, ``alias`` (the
        outputs that are arguments' storage), ``temp`` and ``peak`` =
        argument + temp + output - alias."""
        p = max(range(self.n_positions), key=lambda i: self.peak[i])
        out = alias = 0
        seen = set()
        for t in _leaf_tensors(outputs, []):
            key = t.untyped_storage()._cdata
            rec = self._stores.get(key)
            if rec is None or key in seen or not rec.owners \
                    or p not in rec.owners:
                continue
            seen.add(key)
            out += rec.nbytes
            if key in self._arg_keys:
                alias += rec.nbytes
        arg, peak = self.arguments[p], self.peak[p]
        return {"argument": arg, "output": out, "alias": alias,
                "temp": peak - arg - out + alias, "peak": peak}

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _decomposes(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs.values(), ins)
        before = {t.untyped_storage()._cdata for t in ins}
        key = _memo_key(func, args, kwargs)
        known = _MEMO.get(key) if key is not None else None
        if known is not None:
            out = _rebuild(known)
        else:
            out = func(*args, **kwargs)
            if key is not None:
                _remember(key, func, out, before)
        self.ops += 1
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,),
                        [])
        new = [o for o in outs if o.untyped_storage()._cdata not in before]
        packet = func._overloadpacket
        if packet in flop_registry:
            self.matmul_flops += flop_registry[packet](*args, **kwargs,
                                                       out_val=out)
        if func in _TRANSCENDENTAL:
            self.transcendentals += out.numel()
        if func in _ALLOC:
            pass
        elif new or func._schema.is_mutable:
            reads = ins[1:] if func in _OVERWRITE else ins
            seen = set()
            for t in reads:
                if id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += _read_bytes(t)
            for o in outs:
                self.bytes += o.numel() * o.element_size()
        own = self._own_outputs(ins, new)
        scratch = _SCRATCH.get(func)
        if scratch is not None and own:
            self._transient(own, scratch(*args, **kwargs))
        return out

    def _transient(self, owners, nbytes: int) -> None:
        """``nbytes`` live on ``owners`` for the length of one op."""
        for i in owners:
            if self.live[i] + nbytes > self.peak[i]:
                self.peak[i] = self.live[i] + nbytes

    def _own_outputs(self, ins, new):
        recs = [r for r in (self._store(t, False) for t in ins)
                if r is not None]
        owned = [r.owners for r in recs if r.owners]
        own = None
        if owned:
            own = owned[0]
            for s in owned[1:]:
                own = own & s
            if not own:
                own = frozenset().union(*owned)
            for r in recs:
                if not r.pinned and (r.owners is None or own < r.owners):
                    self._move(r, own)
        for o in new:
            rec = self._store(o, True)
            self.allocated += rec.nbytes
            if own is not None and rec.owners is None:
                self._move(rec, own)
        return own if own is not None else self._all


# Output metadata of pure ops on ``meta`` tensors, by the op and its
# arguments' metadata: a meta kernel is a function of them alone, so a
# repeat (every position runs the same ops) makes its outputs with
# ``empty_strided`` instead of running the kernel again (many meta
# kernels are Python and cost ~250 us an op).
_MEMO: dict = {}
_META = torch.device("meta")


def _arg_key(a):
    if isinstance(a, torch.Tensor):
        if a.device != _META:
            raise TypeError
        return (tuple(a.shape), a.stride(), a.dtype, a.requires_grad)
    if isinstance(a, (list, tuple)):
        return tuple(_arg_key(x) for x in a)
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.memory_format,
                                   torch.layout)):
        return a
    raise TypeError


def _memo_key(func, args, kwargs):
    """The op and its arguments' metadata, or ``None`` where an argument
    is not a ``meta`` tensor or a plain value."""
    if func._schema.is_mutable:
        return None
    try:
        return (func, _arg_key(args), tuple(sorted(
            (k, _arg_key(v)) for k, v in kwargs.items())))
    except TypeError:
        return None


def _remember(key, func, out, before) -> None:
    """Keep ``out``'s metadata where it is fresh ``meta`` tensors (no
    output aliases an input)."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if not outs or not all(isinstance(o, torch.Tensor) and o.device == _META
                           and o.untyped_storage()._cdata not in before
                           for o in outs):
        return
    meta = tuple((tuple(o.shape), o.stride(), o.dtype) for o in outs)
    _MEMO[key] = (type(out), meta) if isinstance(out, (tuple, list)) \
        else (None, meta)


def _rebuild(known):
    kind, meta = known
    outs = [torch.empty_strided(shape, stride, dtype=dtype, device=_META)
            for shape, stride, dtype in meta]
    return outs[0] if kind is None else kind(outs)


_CIA = torch._C.DispatchKey.CompositeImplicitAutograd
_DECOMPOSES: dict = {}


def _decomposes(func) -> bool:
    """Whether ``func.decompose`` has a decomposition to run (what
    ``FlopCounterMode`` tries first on every op), cached an op."""
    got = _DECOMPOSES.get(func)
    if got is None:
        got = _DECOMPOSES[func] = func not in _SKIP and (
            _CIA in func.py_kernels
            or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(),
                                                              _CIA))
    return got


def _read_bytes(t: torch.Tensor) -> int:
    """The distinct bytes a read of ``t`` touches (an expanded view reads
    its storage's elements once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _leaf_tensors(tree, out: list) -> list:
    from ..sharding import Sharded

    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, Sharded):
        out.extend(tree.pieces.values())
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaf_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaf_tensors(v, out)
    return out


__all__ = ["CostMode"]
