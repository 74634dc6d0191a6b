"""The port's names against the reference's, on the CPU.

- Every name the reference serves lazily at its top level
  (``mxtpu/__init__.py``'s ``lazy`` set, and ``kv``) resolves in
  ``mxtpu_torch`` to the port's module when that module is ported, and
  otherwise raises ``AttributeError`` naming its ROADMAP item; so does
  every name of ``mxtpu.parallel.__all__`` in ``mxtpu_torch.parallel``,
  and every name of ``mxtpu.contrib``.
- ``amp.convert_model`` on a zoo net's ``export`` (symbol and
  ``.params``, read back with ``load_checkpoint``) casts the same arg
  params to the same dtype with the same bits as the reference's, and
  leaves the aux params and the symbol as they were.
"""
import ast
import inspect

import numpy as onp
import pytest
import torch

import mxtpu as jmx
import mxtpu.parallel as jpar
import mxtpu_torch as tmx

torch.set_num_threads(2)   # a CPU share for each xdist worker


def reference_lazy_names():
    """The ``lazy`` set of ``mxtpu.__getattr__``, read from its source."""
    tree = ast.parse(inspect.getsource(jmx.__getattr__))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "lazy":
            return sorted(ast.literal_eval(node.value))
    raise AssertionError("mxtpu.__getattr__ has no lazy set")


NAMES = reference_lazy_names() + ["kv"]


def _reference_has(name):
    try:
        getattr(jmx, name)
    except AttributeError:
        return False
    return True


@pytest.mark.parametrize("name", NAMES)
def test_top_level_name_resolves_or_names_its_item(name):
    try:
        mod = getattr(tmx, name)
    except AttributeError as e:
        # a name the reference lists without a module (``utils``) is
        # missing in both; any other is not ported yet, and says when
        if _reference_has(name):
            assert "ROADMAP Queue A item" in str(e), (name, str(e))
        return
    assert inspect.ismodule(mod) and mod.__name__.startswith("mxtpu_torch")
    assert getattr(tmx, name) is mod
    if _reference_has(name):
        ref = getattr(jmx, name).__name__.split(".")[1:]
        assert mod.__name__.split(".")[1:] == ref, name


def test_the_ported_subsystems_are_served():
    for name in ("serve", "parallel", "models", "ops", "contrib",
                 "checkpoint", "serde", "rnn", "image", "recordio",
                 "native", "telemetry", "io", "gluon"):
        assert inspect.ismodule(getattr(tmx, name)), name
    assert tmx.rnn is tmx.gluon.rnn
    with pytest.raises(AttributeError, match="no attribute"):
        tmx.definitely_not_a_module


@pytest.mark.parametrize("name", sorted(jpar.__all__))
def test_parallel_name_resolves_or_names_item_11(name):
    from mxtpu_torch import parallel as tpar
    try:
        obj = getattr(tpar, name)
    except AttributeError as e:
        # only the elastic names still wait, for item 11c
        assert "ROADMAP Queue A item 11c" in str(e), name
        assert name in tpar._LATER and name.startswith(
            ("Elastic", "Fused", "Journaled", "Step")), name
        return
    ref = getattr(jpar, name)
    assert callable(obj) == callable(ref) and \
        inspect.isclass(obj) == inspect.isclass(ref), name
    assert name in tpar.__all__


def test_the_sixteen_parallel_names_are_ported():
    from mxtpu_torch import parallel as tpar
    sixteen = ["make_train_step", "make_eval_step", "TrainState",
               "init_state", "create_mesh", "current_mesh", "use_mesh",
               "MeshConfig", "MESH_AXES", "mesh_axes", "axis_size", "P",
               "ShardingRules", "batch_spec", "named", "replicated"]
    for name in sixteen:
        assert getattr(tpar, name) is not None
    assert tpar.make_train_step is tpar.step.make_train_step
    assert tpar.create_mesh is tpar.mesh.create_mesh
    assert tpar.P is tpar.sharding.P
    assert tuple(tpar.MESH_AXES) == tuple(jpar.MESH_AXES)


def test_contrib_names():
    import mxtpu.contrib as jcon
    for name in sorted(set(jcon.__all__) | {"box_nms", "MultiBoxPrior",
                                             "boolean_mask", "chaos"}):
        assert getattr(tmx.contrib, name) is not None, name
    assert inspect.ismodule(tmx.contrib.quantization)
    # ported: the six names resolve to the port's modules of the
    # reference's names (tensorboard is summary in both)
    for name in ("onnx", "text", "summary", "tensorboard", "deploy",
                 "analysis"):
        mine, ref = getattr(tmx.contrib, name), getattr(jcon, name)
        assert inspect.ismodule(mine), name
        assert mine.__name__ == ref.__name__.replace("mxtpu.",
                                                     "mxtpu_torch.", 1)
    assert tmx.contrib.tensorboard is tmx.contrib.summary


def test_item_10_4b_names_resolve():
    """``mx.operator``, ``mx.nd.sparse``, ``mx.nd.Custom`` and
    ``mx.contrib.quantization`` resolve to the port's modules, and the
    names still to come say which item brings them: 10.4(d) or 11,
    never 10.4(b) or 10.4(c)."""
    assert tmx.operator.__name__ == "mxtpu_torch.operator"
    assert tmx.nd.sparse.__name__ == "mxtpu_torch.ndarray.sparse"
    assert tmx.nd.Custom is tmx.operator.Custom
    assert tmx.contrib.quantization.__name__ == \
        "mxtpu_torch.contrib.quantization"
    assert tmx.nd.quantize_v2 is tmx.contrib.quantization.quantize
    for name in NAMES:
        try:
            getattr(tmx, name)
        except AttributeError as e:
            msg = str(e)
            assert "10.4(b)" not in msg and "10.4(c)" not in msg, name
            if "ROADMAP" in msg:
                assert any(i in msg for i in ("item 10.4(d)", "item 11")), \
                    (name, msg)


def test_item_10_4c_names_resolve():
    """``np``, ``npx``, ``profiler``, ``util``, ``test_utils``, ``engine``
    and ``runtime`` resolve under the reference's top-level names to the
    port's modules of the reference's module names; only the kvstore
    waits."""
    for name in ("np", "npx", "profiler", "util", "test_utils", "engine",
                 "runtime"):
        mod = getattr(tmx, name)
        assert inspect.ismodule(mod), name
        assert mod.__name__.split(".")[1:] == \
            getattr(jmx, name).__name__.split(".")[1:], name
    assert set(tmx._LATER) == {"kvstore", "kv"}
    for name in ("Context", "tpu", "current_context", "num_gpus",
                 "num_tpus", "NDArray"):
        assert callable(getattr(tmx, name)) and hasattr(jmx, name), name
    assert tmx.np.random.__name__ == "mxtpu_torch.numpy.random"


@pytest.mark.parametrize("target", ["bfloat16", "float16"])
def test_convert_model_matches_mxtpu(tmp_path, target):
    tmx.random.seed(1)
    net = tmx.gluon.model_zoo.vision.get_model("mobilenet0.25", classes=10)
    net.initialize(ctx="cpu")
    net.hybridize()
    net(tmx.nd.array(onp.random.default_rng(0).standard_normal(
        (1, 3, 32, 32)), ctx="cpu"))
    prefix = str(tmp_path / "mnet")
    net.export(prefix, epoch=0)
    tsym, targs, taux = tmx.model.load_checkpoint(prefix, 0, ctx="cpu")
    jsym, jargs, jaux = jmx.model.load_checkpoint(prefix, 0)
    tout = tmx.amp.convert_model(tsym, targs, taux, target_dtype=target)
    jout = jmx.amp.convert_model(jsym, jargs, jaux, target_dtype=target)
    assert tout[0] is tsym and jout[0] is jsym
    assert sorted(tout[1]) == sorted(jout[1]) == sorted(targs)
    cast = 0
    for k, tv in tout[1].items():
        jv = jout[1][k]
        assert tmx.base.dtype_name(tv.dtype) == onp.dtype(jv.dtype).name, k
        # both widened to float32 (exact), then compared bit for bit
        tw = tv.astype("float32").asnumpy()
        jw = onp.asarray(jv.asnumpy(), onp.float32)
        assert tw.tobytes() == jw.tobytes(), k
        cast += tmx.base.dtype_name(tv.dtype) == target
    assert 0 < cast < len(targs)          # gamma and beta stay float32
    assert all(tmx.base.dtype_name(tout[1][k].dtype) == "float32"
               for k in targs if k.endswith(("gamma", "beta")))
    for k, v in tout[2].items():
        assert v is taux[k]
        assert onp.asarray(v.asnumpy()).tobytes() == \
            onp.asarray(jout[2][k].asnumpy()).tobytes()
