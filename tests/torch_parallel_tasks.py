"""The rank side of the port's multi-rank tests (``tests/
test_torch_parallel*.py``, ``test_torch_gluon_mesh.py``): functions that
:class:`torch_rank_pool.RankPool` runs on every rank. They import only
torch, numpy and ``mxtpu_torch``, take numpy inputs and return numpy
results (each rank its own), so the test process holds them against
``mxtpu`` run on the same mesh shapes."""
from __future__ import annotations

import functools

import numpy as np
import torch

from mxtpu_torch.parallel import collectives as C
from mxtpu_torch.parallel import dist
from mxtpu_torch.parallel import mesh as M
from mxtpu_torch.parallel import sharding as S


@functools.lru_cache(maxsize=None)
def mesh_of(**axes):
    """One mesh per shape for the life of the rank (building one is a
    collective over every rank)."""
    return M.create_mesh(**axes)


def rank_info():
    """This rank's index and count, its backend, and what it imported
    of jax or mxtpu (nothing: the port never imports them)."""
    import sys
    import torch.distributed as tdist
    return dist.process_index(), dist.process_count(), \
        tdist.get_backend(), sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib",
                                                           "mxtpu"))


def _full(t):
    return np.asarray(S.to_full(t).detach())


def _tree_np(tree):
    from mxtpu_torch.parallel._tree import tree_map
    return tree_map(_full, tree)


def _rules(pairs):
    return S.ShardingRules([(pat, S.P(*spec)) for pat, spec in pairs])


def _spec(spec):
    return S.P(*spec)


# -- mesh, rules, shards ------------------------------------------------------
def mesh_info(configs):
    """Per axes dict: the resolved sizes, the DeviceMesh's dims and this
    rank's index on each axis; or the error a bad shape raises."""
    out = []
    for axes in configs:
        try:
            m = mesh_of(**axes)
        except ValueError as e:
            out.append(("ValueError", str(e)))
            continue
        out.append((m.shape, m.dm_axes, {a: C.axis_index(a, m)
                                         for a in M.MESH_AXES}))
    return out


def local_shards(tree, pairs, axes):
    """``shard_pytree`` of a numpy tree by the rule table: this rank's
    local shard of each leaf, by path."""
    from mxtpu_torch.parallel._tree import path_str, tree_flatten_with_path
    mesh = mesh_of(**axes)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
    placed = S.shard_pytree(t, mesh, _rules(pairs))
    return {path_str(p): np.asarray(x.to_local())
            for p, x in tree_flatten_with_path(placed)}


def model_shards(model, tree, axes, cfg_kw=None):
    """``shard_pytree`` of a model's numpy tree by its own rules: this
    rank's local shards, by path."""
    from mxtpu_torch.parallel._tree import path_str, tree_flatten_with_path
    mesh = mesh_of(**axes)
    if model == "llama":
        from mxtpu_torch.models import llama as mod
        rules = mod.sharding_rules(_llama_cfg(cfg_kw or {}))
    else:
        from mxtpu_torch.models import bert as mod
        rules = mod.sharding_rules()
    placed = S.shard_pytree(mod.params_from_numpy(tree, device="cpu"),
                            mesh, rules)
    return {path_str(p): np.asarray(x.to_local())
            for p, x in tree_flatten_with_path(placed)}


def constrain_roundtrip(x, axes, specs):
    """``x`` laid out by each spec in turn (``constrain`` under the
    mesh); this rank's local shard after each, and whether ``constrain``
    outside the mesh was a no-op."""
    mesh = mesh_of(**axes)
    t = torch.from_numpy(x)
    outside = S.constrain(t, "dp") is t
    locs = []
    with M.use_mesh(mesh):
        for sp in specs:
            t = S.constrain(t, *sp)
            locs.append(np.asarray(t.to_local()))
        full = _full(t)
    return outside, locs, full


# -- collectives --------------------------------------------------------------
def collective(name, x, axes, in_spec, out_spec, kw, w):
    """``name`` under ``shard_map`` on the global ``x`` laid out
    ``in_spec``: the global output (``out_spec``) and the gradient of
    sum(out * w) with respect to ``x``."""
    mesh = mesh_of(**axes)
    kw = dict(kw)
    expand = kw.pop("expand", False)      # one copy of the output a rank
    fn = getattr(C, name)
    xt = torch.from_numpy(x).requires_grad_()
    f = C.shard_map(lambda v: fn(v, **kw, mesh=mesh)[None] if expand
                    else fn(v, **kw, mesh=mesh), mesh,
                    (_spec(in_spec),), _spec(out_spec))
    with S.spmd(mesh):
        out = f(xt)
        loss = S.mcon(mesh, (out * torch.from_numpy(w)).sum())
        g, = torch.autograd.grad(loss, xt)
    return _full(out), np.asarray(g)


def uneven_shard_map(cases):
    """Per (shape, axes, spec): the error ``shard_map`` raises on an
    array of ``shape`` laid out ``spec`` (None if it raises none); then
    the error of a lookup into a 10-row table blocked over tp=4."""
    from mxtpu_torch.parallel.sparse_embed import sharded_embedding_lookup
    out = []
    for shape, axes, spec in cases:
        f = C.shard_map(lambda v: v, mesh_of(**axes), (_spec(spec),),
                        _spec(spec))
        try:
            f(torch.zeros(shape))
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    try:
        sharded_embedding_lookup(torch.zeros(10, 4), torch.zeros(2, 3),
                                 mesh_of(tp=4), axis="tp")
        out.append(None)
    except ValueError as e:
        out.append(str(e))
    return out


def axis_indices(axes, names):
    mesh = mesh_of(**axes)
    return [C.axis_index(a, mesh) for a in names]


def barrier():
    before = C.issued["barrier"]
    C.barrier_sync()
    return C.issued["barrier"] - before


# -- the train step -----------------------------------------------------------
def linear_train(w, xs, ys, axes, pairs, opt, steps, grad_accum=1,
                 poison=False):
    """``steps`` steps of mean((x @ w - y)^2) on the mesh (``axes``
    None: no mesh): the losses, the final w and the optimizer state's
    leaves with their DTensor placements (as strings)."""
    from mxtpu_torch.parallel import optim, step as pstep
    from mxtpu_torch.parallel._tree import tree_leaves
    mesh = None if axes is None else mesh_of(**axes)
    tx = optim.sgd(0.1) if opt == "sgd" else optim.adamw(1e-2)
    rules = None if pairs is None else _rules(pairs)

    def loss_fn(params, batch):
        x, y = batch
        return ((x @ params["w"] - y) ** 2).mean()

    state = pstep.init_state({"w": torch.from_numpy(w)}, tx, mesh, rules)
    fn = pstep.make_train_step(loss_fn, tx, mesh, rules,
                               grad_accum=grad_accum, skip_nonfinite=poison)
    batch = (torch.from_numpy(xs), torch.from_numpy(ys))
    losses, skipped = [], []
    for i in range(steps):
        if poison and i == 0:
            bad = (batch[0] * float("inf"), batch[1])
            state, loss, sk = fn(state, bad)
            skipped.append(bool(sk))
        out = fn(state, batch)
        state, loss = out[0], out[1]
        if poison:
            skipped.append(bool(out[2]))
        losses.append(float(loss))
    opt_leaves = [(tuple(t.shape), str(getattr(t, "placements", "plain")))
                  for t in tree_leaves(state.opt_state)]
    return losses, _full(state.params["w"]), opt_leaves, skipped, \
        str(getattr(state.params["w"], "placements", "plain"))


def eval_linear(w, xs, axes):
    from mxtpu_torch.parallel import step as pstep
    mesh = mesh_of(**axes)
    step = pstep.make_eval_step(lambda p, x: x @ p["w"], mesh)
    params = S.shard_pytree({"w": torch.from_numpy(w)}, mesh,
                            _rules([(".*", ())]))
    return np.asarray(step(params, torch.from_numpy(xs)))


def _llama_cfg(kw):
    from dataclasses import replace
    from mxtpu_torch.models import llama
    kw = dict(kw)
    base = kw.pop("base", "tiny")
    kw.setdefault("dtype", torch.float32)
    kw.setdefault("remat", False)
    return replace(llama.CONFIGS[base], **kw)


def llama_train(tree, tokens, axes, cfg_kw, steps=3, lr=0.1, opt="sgd",
                grad_accum=1):
    """``steps`` steps of the port's Llama train step on
    ``mesh_of(**axes)`` (None: no mesh) by ``sharding_rules``: the
    losses and, from rank 0, the final params gathered whole."""
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel import optim, step as pstep
    cfg = _llama_cfg(cfg_kw)
    mesh = None if axes is None else mesh_of(**axes)
    tx = optim.sgd(lr) if opt == "sgd" else optim.adamw(lr)
    rules = None if mesh is None else llama.sharding_rules(cfg)
    state = pstep.init_state(llama.params_from_numpy(tree, device="cpu"),
                             tx, mesh, rules)
    fn = pstep.make_train_step(llama.loss_fn(cfg, mesh), tx, mesh, rules,
                               grad_accum=grad_accum)
    tok = torch.from_numpy(np.asarray(tokens))
    if grad_accum > 1:
        tok = tok.reshape((grad_accum, -1) + tuple(tok.shape[1:]))
    losses = []
    for _ in range(steps):
        state, loss = fn(state, {"tokens": tok})
        losses.append(float(loss))
    full = _tree_np(state.params)            # a collective: every rank
    return losses, (full if dist.process_index() == 0 else None)


def llama_forward(tree, tokens, axes, cfg_kw):
    """The port's Llama logits on the mesh, gathered whole."""
    from mxtpu_torch.models import llama
    cfg = _llama_cfg(cfg_kw)
    mesh = None if axes is None else mesh_of(**axes)
    params = llama.params_from_numpy(tree, device="cpu")
    if mesh is not None and mesh.distributed:
        params = S.shard_pytree(params, mesh, llama.sharding_rules(cfg))
    with torch.no_grad():
        out = llama.forward(cfg, params, torch.from_numpy(tokens), mesh)
    full = _full(out)                        # a collective: every rank
    return full if dist.process_index() == 0 else None


# -- attention ----------------------------------------------------------------
def attention(kind, q, k, v, w, axes, spec, causal):
    """Ring or Ulysses attention under ``shard_map`` (``spec`` for q, k,
    v and the output): the global output and the gradients of
    sum(out * w) with respect to q, k and v."""
    from functools import partial
    from mxtpu_torch.ops import attention as A
    mesh = mesh_of(**axes)
    kernel = A.ring_attention if kind == "ring" else A.ulysses_attention
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    sp = _spec(spec)
    f = C.shard_map(partial(kernel, axis_name="sp", causal=causal,
                            mesh=mesh), mesh, (sp,) * 3, sp)
    with S.spmd(mesh):
        out = f(*ts)
        loss = S.mcon(mesh, (out * torch.from_numpy(w)).sum())
        grads = torch.autograd.grad(loss, ts)
    return _full(out), [np.asarray(g) for g in grads]


# -- sparse embedding, MoE, pipeline --------------------------------------------
def embedding(table, ids, axes, axis):
    """The sharded lookup (global result) and the table's gradient of
    sum(out ** 2), gathered whole; and the table's local block."""
    from mxtpu_torch.parallel import sparse_embed as SE
    mesh = mesh_of(**axes)
    t = SE.shard_embedding(torch.from_numpy(table), mesh, axis=axis)
    t.requires_grad_()
    with S.spmd(mesh):
        out = SE.sharded_embedding_lookup(t, torch.from_numpy(ids), mesh,
                                          axis=axis)
        loss = S.mcon(mesh, (out ** 2).sum())
        g, = torch.autograd.grad(loss, t)
    return _full(out), _full(g), np.asarray(t.to_local().detach()), \
        str(g.placements)


def moe(params, x, axes, kw, dense=False):
    """``moe_ffn`` (or ``moe_ffn_dense``) with the banks laid out
    ``P("ep")``: out, aux and the gradients of sum(out * out) + aux with
    respect to the params and x, gathered whole; and the local bank
    shape."""
    from mxtpu_torch.parallel import moe as MO
    mesh = None if axes is None else mesh_of(**axes)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    if mesh is not None:
        specs = {"gate": (), "w_gate": ("ep",), "w_up": ("ep",),
                 "w_down": ("ep",)}
        p = {k: S.global_device_put(v, S.named(mesh, *specs[k]))
             for k, v in p.items()}
    for v in p.values():
        v.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    fn = MO.moe_ffn_dense if dense else MO.moe_ffn
    with S.spmd(mesh):
        out, aux = fn(p, xt, mesh=mesh, **kw)
        loss = S.mcon(mesh, (out * out).sum() + aux) if mesh is not None \
            else (out * out).sum() + aux
        grads = torch.autograd.grad(loss, list(p.values()) + [xt])
    names = list(p) + ["x"]
    local = tuple(getattr(p["w_gate"], "to_local", lambda: p["w_gate"])()
                  .shape)
    return _full(out), float(_full(aux)), \
        {n: _full(g) for n, g in zip(names, grads)}, local


def gpipe_llama(tree, x, axes, cfg_kw, n_micro):
    """``gpipe`` of the Llama layer stack over ``pp``: the output and
    the layer weights' gradients of sum(out ** 2), gathered whole."""
    from functools import partial
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel.pipeline import gpipe
    cfg = _llama_cfg(cfg_kw)
    mesh = mesh_of(**axes)
    layers = {k: torch.from_numpy(v).requires_grad_()
              for k, v in tree.items()}
    xt = torch.from_numpy(x).requires_grad_()
    cos, sin = llama.rope_tables(cfg, x.shape[1])

    def layer_fn(lp, h):
        return llama._layer(cfg, cos, sin, h, lp)[0]

    with S.spmd(mesh):
        out = gpipe(layer_fn, layers, xt, mesh=mesh,
                    n_microbatches=n_micro)
        loss = S.mcon(mesh, (out ** 2).sum())
        grads = torch.autograd.grad(loss, list(layers.values()) + [xt])
    names = list(layers) + ["x"]
    return _full(out), {n: _full(g) for n, g in zip(names, grads)}


def gpipe_affine(ws, bs, x, axes, n_micro):
    """``gpipe`` of tanh(x @ w + b) layers over ``pp``."""
    from mxtpu_torch.parallel.pipeline import gpipe
    mesh = mesh_of(**axes)
    params = {"w": torch.from_numpy(ws), "b": torch.from_numpy(bs)}
    with S.spmd(mesh):
        out = gpipe(lambda lp, h: torch.tanh(h @ lp["w"] + lp["b"]), params,
                    torch.from_numpy(x), mesh=mesh, n_microbatches=n_micro)
    return _full(out)


# -- BERT ----------------------------------------------------------------------
def bert_train(tree, batch, axes, cfg_kw, steps, lr):
    """``steps`` sgd steps of the port's BERT loss on the mesh by its
    rules: the losses and, from rank 0, the final params whole."""
    from dataclasses import replace
    from mxtpu_torch.models import bert
    from mxtpu_torch.parallel import optim, step as pstep
    kw = dict(cfg_kw)
    kw.setdefault("dtype", torch.float32)
    cfg = replace(bert.CONFIGS[kw.pop("base", "tiny")], **kw)
    mesh = None if axes is None else mesh_of(**axes)
    tx = optim.sgd(lr)
    rules = None if mesh is None else bert.sharding_rules(cfg)
    state = pstep.init_state(bert.params_from_numpy(tree, device="cpu"),
                             tx, mesh, rules)
    fn = pstep.make_train_step(bert.loss_fn(cfg, mesh), tx, mesh, rules)
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        state, loss = fn(state, b)
        losses.append(float(loss))
    full = _tree_np(state.params)            # a collective: every rank
    return losses, (full if dist.process_index() == 0 else None)


# -- Gluon on a mesh ------------------------------------------------------------
def gluon_llama(tree, tokens, axes, cfg_kw, steps, lr, momentum=0.0,
                grad_accum=1, amp=False):
    """``GluonLlama`` loaded with ``tree``, ``shard``-ed on the mesh by
    llama's rules, trained by ``Trainer.make_fused_step``: the losses,
    the applied updates, the variants built, this rank's block of the
    expert bank (if any) and, from rank 0, the params whole."""
    import mxtpu_torch as mx
    from mxtpu_torch.gluon.model_zoo import GluonLlama
    from mxtpu_torch.models import llama
    cfg = _llama_cfg(cfg_kw)
    mesh = mesh_of(**axes)
    net = GluonLlama(cfg)
    net.load_pytree(tree, ctx="cpu")
    net.hybridize()
    net.shard(mesh, llama.sharding_rules(cfg))
    opts = {"learning_rate": lr, "wd": 0.0}
    if momentum:
        opts["momentum"] = momentum
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", opts)
    if amp:
        mx.amp.init("float16")
        mx.amp.init_trainer(tr)
        tr._amp_loss_scaler.loss_scale = 1e38     # overflows at first
    fused = tr.make_fused_step(net, grad_accum=grad_accum)
    tok = mx.nd.array(np.asarray(tokens), ctx="cpu")
    losses = [float(fused(tok, tok).asscalar()) for _ in range(steps)]
    bank = net._reg_params.get("layers_w_gate")
    local = None if bank is None else tuple(bank.data()._data.to_local()
                                            .shape)
    full = {a: p.data().asnumpy() for a, p in net._reg_params.items()}
    return losses, fused.applied_updates(), fused.num_compiles(), local, \
        (full if dist.process_index() == 0 else None)


def llama_grads(tree, tokens, axes, cfg_kw):
    """The port's Llama loss gradients on the mesh (whole) and on no
    mesh, by leaf: the largest difference."""
    from mxtpu_torch.models import llama
    from mxtpu_torch.parallel._tree import path_str, tree_flatten_with_path
    cfg = _llama_cfg(cfg_kw)
    mesh = mesh_of(**axes)
    out = {}
    for m in (None, mesh):
        params = llama.params_from_numpy(tree, device="cpu")
        if m is not None:
            params = S.shard_pytree(params, m, llama.sharding_rules(cfg))
        leaves = [t.requires_grad_() for _, t in
                  tree_flatten_with_path(params)]
        names = [path_str(p) for p, _ in tree_flatten_with_path(params)]
        with S.spmd(m):
            loss = llama.loss_fn(cfg, m)(params, {
                "tokens": S.mcon(m, torch.from_numpy(tokens), ("dp", "fsdp"))
                if m is not None else torch.from_numpy(tokens)})
            loss = S.mcon(m, loss) if m is not None else loss
            gs = torch.autograd.grad(loss, leaves)
        out[m is None] = {n: _full(g) for n, g in zip(names, gs)}
    return {n: float(np.abs(out[False][n] - out[True][n]).max() /
                     max(1e-30, np.abs(out[True][n]).max()))
            for n in out[True]}


def opt_specs(axes, pairs):
    """``opt_state_shardings`` of adamw over {w (8, 8), b (3,)}: the
    specs of the count and of w's and b's moments."""
    from mxtpu_torch.parallel import optim, step as pstep
    params = {"w": torch.zeros(8, 8), "b": torch.zeros(3)}
    st = pstep.opt_state_shardings(optim.adamw(1e-2), params,
                                   mesh_of(**axes), _rules(pairs))
    return {"count": tuple(st.count.spec),
            **{f"{m}/{k}": tuple(getattr(st, m)[k].spec)
               for m in ("mu", "nu") for k in ("w", "b")}}
