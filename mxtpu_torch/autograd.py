"""Imperative autograd: ``record()``/``pause()`` scopes, tape, ``backward()``
— the port of ``mxtpu/autograd.py``.

Every op executed under ``record()`` whose inputs are on the tape runs
under ``torch.enable_grad()`` on detached views of its tracked inputs,
set to require grad, and the tape's :class:`Node` keeps the pullback: a call of
``torch.autograd.grad`` on that small graph (``retain_graph=True``, so it
can be called again). ``backward()`` walks the tape in reverse creation
order, calling pullbacks and writing leaf ``.grad`` buffers per
``grad_req`` ('write' | 'add' | 'null'). As in the reference, the tape is
never freed by a ``backward``: ``retain_graph`` is accepted and not read,
so a second ``backward`` on the same head works ('write' writes the same
grads again, 'add' doubles them).

A hybridized Gluon block's call (the reference's CachedOp, whose
``invoke`` branch defers the linearisation to a cached jitted backward)
is one node like any op's here: its forward runs once under
``enable_grad`` and its pullback is one ``torch.autograd.grad`` over the
graph that run built, which torch keeps, so nothing is re-traced.
"""
from __future__ import annotations

import heapq
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "record", "pause", "train_mode", "predict_mode",
    "is_recording", "is_training", "backward", "grad",
    "mark_variables", "Function",
]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        _state.counter = 0
    return _state


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec, self._train = recording, training

    def __enter__(self):
        st = _st()
        self._old = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._old


def record(train_mode: bool = True) -> _Scope:
    """Scope in which executed ops are recorded on the tape."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    """Scope in which recording is suspended."""
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


# ---------------------------------------------------------------------------
# Tape
# ---------------------------------------------------------------------------
class Leaf:
    """A gradient-requiring variable (created by NDArray.attach_grad)."""

    __slots__ = ("array", "grad_req", "seq")

    def __init__(self, array, grad_req: str):
        self.array = array          # the NDArray whose .grad we fill
        self.grad_req = grad_req    # 'write' | 'add' | 'null'
        self.seq = -1


class Node:
    """One recorded op: holds the pullback and parent links.

    parents[i] describes where input i of the op came from:
      (Node, out_index)  — output of an earlier recorded op
      Leaf               — a grad-attached variable
      None               — constant (no gradient flows)
    """

    __slots__ = ("vjp_fn", "parents", "out_avals", "seq", "name",
                 "out_is_tuple")

    def __init__(self, vjp_fn, parents, out_avals, name="",
                 out_is_tuple=False):
        st = _st()
        st.counter += 1
        self.seq = st.counter
        self.vjp_fn = vjp_fn
        self.parents = parents
        self.out_avals = out_avals  # list[(shape, dtype, device)] per output
        self.name = name
        self.out_is_tuple = out_is_tuple  # primal returned a tuple


def _differentiable(x) -> bool:
    return isinstance(x, torch.Tensor) and (x.is_floating_point()
                                            or x.is_complex())


def _pullback(outs: Sequence[torch.Tensor], ins: Sequence[Any]):
    """The vjp of ``outs`` with respect to the tensors of ``ins`` that
    require grad: a tuple with one entry per input (None for inputs that
    are not differentiable, zeros for those the outputs do not use)."""
    wrt = [i for i, t in enumerate(ins)
           if isinstance(t, torch.Tensor) and t.requires_grad]

    def vjp_fn(cot):
        cots = cot if isinstance(cot, tuple) else (cot,)
        pairs = [(o, c.to(o.dtype)) for o, c in zip(outs, cots)
                 if o.requires_grad]
        res: List[Any] = [None] * len(ins)
        grads = [None] * len(wrt)
        if pairs and wrt:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [ins[i] for i in wrt],
                [c for _, c in pairs], retain_graph=True, allow_unused=True)
        for i, g in zip(wrt, grads):
            res[i] = torch.zeros_like(ins[i]) if g is None else g
        return tuple(res)
    return vjp_fn


def invoke(raw_fn: Callable, arrays: Sequence[Any], parents: Sequence[Any],
           name: str = "", has_aux: bool = False) -> Tuple[Any, Optional[Node]]:
    """Run ``raw_fn(*arrays)`` (tensors in, a tensor or tuple out).

    If recording and any parent is tracked, run it on detached views of
    the tracked inputs that require grad and return (detached outputs,
    Node); otherwise plain execution, Node=None. With ``has_aux``, raw_fn
    returns ``(out, aux)`` and invoke returns ``((out, aux), node)``; aux
    takes no gradient.
    """
    tracked = is_recording() and any(p is not None for p in parents)
    if not tracked:
        return raw_fn(*arrays), None
    ins = [a.detach().requires_grad_()
           if p is not None and _differentiable(a) else a
           for a, p in zip(arrays, parents)]
    with torch.enable_grad():
        result = raw_fn(*ins)
    out, aux = result if has_aux else (result, None)
    outs = out if isinstance(out, tuple) else (out,)
    avals = [(o.shape, o.dtype, o.device) for o in outs]
    node = Node(_pullback(outs, ins), list(parents), avals, name,
                out_is_tuple=isinstance(out, tuple))
    detached = tuple(o.detach() for o in outs)
    out = detached if isinstance(out, tuple) else detached[0]
    if has_aux:
        return (out, aux), node
    return out, node


def backward(heads: Sequence[Any], head_grads: Optional[Sequence[Any]] = None,
             retain_graph: bool = False, train_mode: bool = True) -> None:
    """Run the tape backward from ``heads`` (NDArrays), filling leaf grads.

    Reference semantics: ``MXAutogradBackwardEx`` → Imperative::Backward.
    """
    from .ndarray.ndarray import NDArray  # local import, avoids cycle

    heads = [h for h in heads]
    if head_grads is None:
        head_grads = [None] * len(heads)

    # out_grads[node] = list per output slot of accumulated cotangents
    out_grads: dict = {}
    leaf_grads: dict = {}
    frontier: List[Node] = []
    seen = set()

    def _route(parent, g):
        """Send cotangent g to a parent slot."""
        if parent is None or g is None:
            return
        if isinstance(parent, Leaf):
            key = id(parent)
            if key in leaf_grads:
                leaf_grads[key] = (parent, leaf_grads[key][1] + g)
            else:
                leaf_grads[key] = (parent, g)
            return
        node, idx = parent
        slots = out_grads.setdefault(id(node), [None] * len(node.out_avals))
        slots[idx] = g if slots[idx] is None else slots[idx] + g
        if id(node) not in seen:
            seen.add(id(node))
            frontier.append(node)

    any_head = False
    for h, hg in zip(heads, head_grads):
        src = getattr(h, "_ag", None)
        if src is None:
            continue
        any_head = True
        g = hg._data if isinstance(hg, NDArray) else hg
        if g is None:
            g = torch.ones_like(h._data)
        elif not isinstance(g, torch.Tensor):      # numpy arrays, scalars
            g = torch.as_tensor(g, device=h._data.device)
        _route(src, g)
    if not any_head:
        raise ValueError(
            "backward() called on heads that were not computed under "
            "autograd.record() and have no attached grad")

    # reverse creation order == valid reverse topological order
    heap = [(-n.seq, i, n) for i, n in enumerate(frontier)]
    heapq.heapify(heap)
    in_heap = {id(n) for n in frontier}
    frontier.clear()
    while heap:
        _, _, node = heapq.heappop(heap)
        in_heap.discard(id(node))
        slots = out_grads.pop(id(node), None)
        if slots is None:
            continue
        cots = tuple(
            s if s is not None else torch.zeros(shape, dtype=dtype,
                                                device=device)
            for s, (shape, dtype, device) in zip(slots, node.out_avals))
        cot = cots if node.out_is_tuple else cots[0]
        in_grads = node.vjp_fn(cot)
        for parent, g in zip(node.parents, in_grads):
            _route(parent, g)
        # move any newly discovered nodes into the heap
        while frontier:
            n = frontier.pop()
            if id(n) not in in_heap:
                heapq.heappush(heap, (-n.seq, id(n), n))
                in_heap.add(id(n))

    # write leaf grads per grad_req
    for _, (leaf, g) in leaf_grads.items():
        arr = leaf.array
        if leaf.grad_req == "null" or arr.grad is None:
            continue
        g = g.to(arr.grad._data.dtype)
        if leaf.grad_req == "add":
            arr.grad._data = arr.grad._data + g
        else:
            arr.grad._data = g


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Functional-style grad: returns grads of heads w.r.t. variables.

    Reference: ``mx.autograd.grad``. Implemented over the same tape by
    temporarily redirecting leaf accumulation.
    """
    from .ndarray.ndarray import NDArray
    single = not isinstance(variables, (list, tuple))
    vs = [variables] if single else list(variables)
    hs = [heads] if not isinstance(heads, (list, tuple)) else list(heads)
    saved = [(v.grad._data if v.grad is not None else None) for v in vs]
    saved_req = []
    for v in vs:
        if v.grad is None:
            raise ValueError("grad() variables must have attach_grad() called")
        saved_req.append(v._ag_leaf.grad_req)
        v.grad._data = torch.zeros_like(v.grad._data)
        v._ag_leaf.grad_req = "add"
    backward(hs, head_grads)
    outs = [NDArray(v.grad._data) for v in vs]
    for v, s, req in zip(vs, saved, saved_req):
        v._ag_leaf.grad_req = req
        if s is not None:
            v.grad._data = s
    return outs[0] if single else outs


def mark_variables(variables, gradients, grad_reqs="write"):
    """Reference ``autograd.mark_variables``: associate grads with vars."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.attach_grad(grad_req=req)
        if g is not None:
            v.grad._data = g._data


class Function:
    """Custom differentiable function (reference ``autograd.Function``).

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` using NDArray math. The backward is
    itself executed untraced.
    """

    def __call__(self, *inputs):
        from .ndarray.ndarray import _parents_of
        with pause():
            outputs = self.forward(*inputs)
        single = not isinstance(outputs, tuple)
        outs = (outputs,) if single else outputs
        if is_recording():
            parents = _parents_of(inputs)
            if any(p is not None for p in parents):
                fn_self = self

                def _vjp(cot):
                    from .ndarray.ndarray import NDArray as ND
                    cots = cot if isinstance(cot, tuple) else (cot,)
                    with pause():
                        gs = fn_self.backward(*[ND(c) for c in cots])
                    if not isinstance(gs, tuple):
                        gs = (gs,)
                    return tuple(g._data if g is not None else None for g in gs)

                node = Node(_vjp, list(parents),
                            [(o._data.shape, o._data.dtype, o._data.device)
                             for o in outs],
                            type(self).__name__, out_is_tuple=not single)
                for i, o in enumerate(outs):
                    o._ag = (node, i)
        return outputs

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
