"""Port parity: serving over a model-parallel group of ranks, mirroring the
JAX package's ``tests/test_serve_mesh.py``.

The port's side is one gloo job of ``tests/_torch_mp_worker.py``
(``serve_mesh``, four ranks): a :data:`SERVE_BERT_GEOM` BERT served by
``BertInferenceEngine`` over a serving group (rank 0 leads, the others
follow) under TP, EP (replicated dispatch) and PP, each beside a data axis
of 2, and under TP and EP at int8; then ``cli.serve`` as a four-rank group
at ``--tp 2`` on a checkpoint the train CLI wrote here. The JAX side runs
its engine on the same mesh of conftest's CPU devices from the same global
parameters (through ``interop``). Tolerances are the JAX test's
``_assert_parity``: ``pred_ids`` equal, ``score`` within 1e-4 relative,
``embedding`` and ``nsp_probs`` within 1e-3 relative and 1e-4 absolute
(fp32), for a lone request (tier 1, its row on every data rank) and a full
tier (tier 4, the rows split over the data ranks); the same against the
port's one-process engine. Also: ``plan_serve_mesh`` and its fallback,
layout labels, ``_serve_config``'s and ``_plan_quant``'s refusals with the
JAX messages, the layout-labelled metrics and ``/statusz``, the CLI's
oversized mesh falling back, and an int8 mixture of experts served at one
process against the JAX int8 engine.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.parallel.mesh import build_mesh as jax_build_mesh
from distributed_tensorflow_tpu.serve import BertInferenceEngine as JaxEngine
from distributed_tensorflow_tpu.serve import plan_serve_mesh as jax_plan
from distributed_tensorflow_tpu_torch.interop import bert_params_to_flax
from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine, plan_serve_mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_mp_worker import (  # noqa: E402
    SERVE_BERT_GEOM,
    SERVE_ENGINE_KW,
    SERVE_LAYOUTS,
    serve_bert,
    serve_payloads,
)
from test_torch_multiprocess import _launch  # noqa: E402

TINY_BERT_FLAGS = ["--bert-layers=1", "--bert-hidden=32", "--bert-vocab=64"]
SERVE_FLAGS = ["--config=bert_base", "--device=cpu", *TINY_BERT_FLAGS, "--buckets", "16",
               "--max-batch=2", "--max-delay-ms=2", "--selftest=3"]


def _assert_parity(ref, got):
    """The JAX tests/test_serve_mesh.py tolerances."""
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a["pred_ids"]), b["pred_ids"])
        np.testing.assert_allclose(a["score"], b["score"], rtol=1e-4)
        np.testing.assert_allclose(np.asarray(a["embedding"]), b["embedding"], rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(a["nsp_probs"]), b["nsp_probs"], rtol=1e-3,
                                   atol=1e-4)
        assert a["bucket"] == b["bucket"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from distributed_tensorflow_tpu_torch.cli.train import main

    d = tmp_path_factory.mktemp("serve_mesh_ckpt") / "ck"
    assert main(["--config=bert_base", "--device=cpu", *TINY_BERT_FLAGS, "--steps=2",
                 "--global-batch=8", "--log-every=1", f"--ckpt-dir={d}"]) == 0
    return d


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ckpt):
    d = tmp_path_factory.mktemp("serve_mesh")
    return d, _launch(d, "serve_mesh", n_groups=2, world=4,
                      argv=[*SERVE_FLAGS, f"--ckpt-dir={ckpt}", "--tp=2"])


def _single(name: str):
    """The port's one-process engine on the layout's checkpoint."""
    _, over, wd = SERVE_LAYOUTS[name]
    model, params = serve_bert(over)
    return BertInferenceEngine(model, params, "cpu", weight_dtype=wd, **SERVE_ENGINE_KW)


def _jax_engine(name: str):
    spec, over, wd = SERVE_LAYOUTS[name]
    _, params = serve_bert(over)
    flax = jax.tree.map(jnp.asarray, bert_params_to_flax(params, SERVE_BERT_GEOM["num_heads"]))
    mesh = jax_build_mesh(spec, devices=jax.devices()[:4])
    return JaxEngine(jbert.BertForPreTraining(jbert.BertConfig(**{**SERVE_BERT_GEOM, **over})),
                     flax, mesh, weight_dtype=wd, **SERVE_ENGINE_KW)


# ------------------------------------------------ mesh planning + labels


def test_plan_serve_mesh_fits_and_falls_back(caplog):
    cases = [dict(), dict(tp=4, n_devices=8), dict(tp=2, pp=2, ep=2, n_devices=8)]
    for kw in cases:
        assert plan_serve_mesh(**{"n_devices": 1, **kw}) == jax_plan(**{"n_devices": 1, **kw})
    assert plan_serve_mesh(tp=4, n_devices=8) == ({"data": -1, "model": 4}, False)
    assert plan_serve_mesh(tp=2, pp=2, ep=2, n_devices=8) == (
        {"data": -1, "pipeline": 2, "expert": 2, "model": 2}, False)
    # Oversized or non-dividing requests degrade to data-parallel serving
    # with a warning, never a shape error at startup.
    with caplog.at_level(logging.WARNING):
        assert plan_serve_mesh(tp=16, n_devices=8) == ({"data": -1}, True)
        assert plan_serve_mesh(tp=3, n_devices=8) == ({"data": -1}, True)
    assert "falling back" in caplog.text
    # Without a process group the serving job's ranks are the cards.
    assert plan_serve_mesh(tp=2)[1] is True


def test_layout_labels():
    from distributed_tensorflow_tpu.parallel.mesh import layout_label as jax_label
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh, layout_label

    assert layout_label(build_mesh({"data": 1}, world_size=1, rank=0)) == "single"
    for spec in ({"data": -1}, {"data": 2, "model": 4}, {"data": 2, "expert": 2, "model": 2}):
        got = layout_label(build_mesh(spec, world_size=8, rank=0))
        assert got == jax_label(jax_build_mesh(spec, devices=jax.devices()[:8]))
    assert layout_label(build_mesh({"data": 2, "model": 4}, world_size=8, rank=0)) == "dp2-tp4"


# ------------------------------------------------- sharded-engine parity


@pytest.mark.parametrize("name", list(SERVE_LAYOUTS))
def test_group_engine_matches_single_process_and_jax(ranks, name):
    """The group's answers against the port's one-process engine and the
    JAX engine on the same mesh (int8: against the one-process int8 engine,
    whose packing test_torch_quant.py holds to JAX's)."""
    _, outs = ranks
    got = outs[0][name]
    spec = SERVE_LAYOUTS[name][0]
    label = "-".join(f"{ {'data': 'dp', 'model': 'tp', 'expert': 'ep', 'pipeline': 'pp'}[a]}{n}"
                     for a, n in spec.items())
    assert got["layout"] == label
    assert got["mesh_info"] == {"layout": label, "mesh_shape": spec, "devices_per_engine": 4,
                                "platform": "cpu"}
    if name.startswith("ep"):
        assert got["moe_dispatch"] == "replicated"
    single = _single(name)
    payloads = serve_payloads()
    for n in (1, 4):
        _assert_parity(single.run_batch(payloads[:n]), got["results"][n])
    if name.endswith("int8"):
        assert got["weight_dtype"] == "int8"
        return
    jeng = _jax_engine(name)
    assert jeng.layout == label
    for n in (1, 4):
        _assert_parity(jeng.run_batch(payloads[:n]), got["results"][n])


def test_serve_config_validation():
    """The port's refusals are the JAX engine's, message for message."""
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig

    cases = [(dict(), (8, 1, 1)), (dict(), (1, 4, 1)), (dict(moe_experts=4), (1, 3, 1)),
             (dict(), (1, 1, 2)), (dict(num_layers=4, pipeline_parallel=4), (1, 1, 2))]
    for over, (tp, ep, pp) in cases:
        with pytest.raises(ValueError) as want:
            JaxEngine._serve_config(jbert.BertConfig(**{**SERVE_BERT_GEOM, **over}), tp, ep, pp)
        with pytest.raises(ValueError) as got:
            BertInferenceEngine._serve_config(BertConfig(**{**SERVE_BERT_GEOM, **over}), tp, ep,
                                              pp)
        assert str(got.value) == str(want.value)
    # int8 under a pipeline axis: the JAX message.
    cfg = BertConfig(**{**SERVE_BERT_GEOM, "num_layers": 2, "pipeline_parallel": 2})
    with pytest.raises(ValueError) as want:
        JaxEngine._plan_quant(jbert.BertConfig(**SERVE_BERT_GEOM), pp=2, weight_dtype="int8")
    with pytest.raises(ValueError) as got:
        BertInferenceEngine._plan_quant(cfg, pp=2, weight_dtype="int8")
    assert str(got.value) == str(want.value)
    # ...and still for the stacked encoder served sequentially.
    with pytest.raises(ValueError, match="stacked-encoder"):
        BertInferenceEngine._plan_quant(cfg, weight_dtype="int8")
    assert BertInferenceEngine._plan_quant(BertConfig(**SERVE_BERT_GEOM, moe_experts=4), ep=2,
                                           weight_dtype="int8") == "int8"


def test_int8_moe_engine_matches_the_jax_int8_engine():
    """A mixture of experts served int8 at one process: the dense kernels
    and the router pack as JAX packs them (the same tree), the expert
    stacks stay fp32, and the answers hold to the JAX int8 engine's at the
    dense int8 engine's tolerances (``tests/test_torch_quant.py``)."""
    from distributed_tensorflow_tpu.models.quant import quantize_params as jax_quantize
    from distributed_tensorflow_tpu_torch.interop import bert_params_from_flax
    from distributed_tensorflow_tpu_torch.models.quant import quantize_params

    over = dict(moe_experts=4, moe_topk=1)
    _, params = serve_bert(over)
    flax = bert_params_to_flax(params, SERVE_BERT_GEOM["num_heads"])
    jax_packed = bert_params_from_flax(jax.tree.map(np.asarray, jax_quantize(
        jax.tree.map(jnp.asarray, flax))))
    ours = quantize_params(params, SERVE_BERT_GEOM["num_heads"])
    assert ours.keys() == jax_packed.keys()
    for k, v in ours.items():
        assert isinstance(v, dict) == isinstance(jax_packed[k], dict), k
        if isinstance(v, dict):
            np.testing.assert_array_equal(v["_q8"].numpy(), jax_packed[k]["_q8"].numpy(), k)
    assert isinstance(ours["bert.layers.0.moe.router.weight"], dict)
    assert not isinstance(ours["bert.layers.0.moe.experts_w1"], dict)
    kw = dict(buckets=(32,), max_batch=1, batch_tiers=(1,), weight_dtype="int8")
    model, _ = serve_bert(over)
    peng = BertInferenceEngine(model, params, "cpu", **kw)
    jeng = JaxEngine(jbert.BertForPreTraining(jbert.BertConfig(**{**SERVE_BERT_GEOM, **over})),
                     jax.tree.map(jnp.asarray, flax),
                     jax_build_mesh({"data": 1}, devices=jax.devices()[:1]), **kw)
    assert peng.weight_dtype == jeng.weight_dtype == "int8"
    for payload in serve_payloads(3):
        ref, got = jeng.run_batch([payload])[0], peng.run_batch([payload])[0]
        np.testing.assert_array_equal(got["pred_ids"], np.asarray(ref["pred_ids"]))
        np.testing.assert_allclose(got["score"], ref["score"], atol=1e-4)
        np.testing.assert_allclose(got["embedding"], np.asarray(ref["embedding"]), atol=1e-4)


# -------------------------------------- layout-labelled observability


def test_client_layout_metrics_and_statusz(ranks):
    _, outs = ranks
    got = outs[0]["tp"]
    snap, status = got["snapshot"], got["statusz"]
    assert set(snap["layout_tier_hits"]) <= {"dp2-tp2/1", "dp2-tp2/4"}
    assert sum(snap["layout_tier_hits"].values()) == sum(snap["tier_hits"].values()) > 0
    assert any(k.startswith("dp2-tp2/") for k in snap["layout_bucket_hits"])
    assert any(k.startswith("dp2-tp2/") for k in snap["layout_phase_ms"])
    assert status["mesh"] == got["mesh_info"]
    assert status["layout_tier_hits"] == snap["layout_tier_hits"]
    # Every dispatch went through the group's channel (the two run_batch
    # calls before the client's), and the stop too.
    assert got["group"]["cells_issued"] == 2 + sum(snap["tier_hits"].values())
    assert got["group"]["stopped"] and got["group"]["broken"] is None


# -------------------------------------------- CLI: leader and followers


def test_cli_selftest_tp_mesh(ranks):
    """``cli.serve --tp 2`` as four ranks: the checkpoint's global tree
    restores on each, the leader serves the selftest as dp2-tp2 and its
    close returns every follower 0."""
    d, outs = ranks
    assert [o["cli_rc"] for o in outs] == [0, 0, 0, 0]
    log = (d / "serve_mesh_rank0.log").read_text()
    assert "(layout dp2-tp2)" in log and "selftest ok: 3 requests" in log
    for r in (1, 2, 3):
        follower = (d / f"serve_mesh_rank{r}.log").read_text()
        assert f"serving group rank {r} (dp2-tp2" in follower
        assert f"serving group rank {r}: stop after" in follower


def test_cli_selftest_oversized_mesh_falls_back(ckpt, caplog):
    """A layout that exceeds the job degrades to one-process serving with
    the warning: the selftest still answers."""
    from distributed_tensorflow_tpu_torch.cli.serve import main

    with caplog.at_level(logging.WARNING):
        assert main([*SERVE_FLAGS, f"--ckpt-dir={ckpt}", "--tp=16"]) == 0
    assert "falling back" in caplog.text


def test_cli_image_preset_with_model_axes_serves_data_parallel(tmp_path, caplog):
    """An image preset given model axes serves data-parallel with the JAX
    CLI's warning (here on a one-rank job: the fallback comes first)."""
    from distributed_tensorflow_tpu_torch.ckpt import save
    from distributed_tensorflow_tpu_torch.cli import serve as serve_cli
    from distributed_tensorflow_tpu_torch.cli import train as train_cli
    from distributed_tensorflow_tpu_torch.parallel import mesh as mesh_lib

    args = serve_cli.make_parser().parse_args(
        ["--config=mnist_lenet", f"--ckpt-dir={tmp_path}", "--device=cpu", "--mesh=model=1"])
    with caplog.at_level(logging.WARNING):
        assert serve_cli.serving_mesh(serve_cli.PRESETS["mnist_lenet"], args) is None
    assert "apply to BERT configs only; serving mnist_lenet data-parallel" in caplog.text
    assert dict(mesh_lib.active_mesh().shape) == {"data": 1}
    model = train_cli._lenet((28, 28, 1), "cpu")
    save(tmp_path, 1, model.state_dict())
    assert serve_cli.main(["--config=mnist_lenet", f"--ckpt-dir={tmp_path}", "--device=cpu",
                           "--tp=2", "--selftest=2"]) == 0


def test_cli_parses_global_batch_and_staleness(ckpt, capsys):
    """The JAX CLI's ``--global-batch`` and ``--staleness``: parsed, checked
    and served with (the restore reads the parameters only)."""
    from distributed_tensorflow_tpu_torch.cli.serve import main

    assert main([*SERVE_FLAGS, f"--ckpt-dir={ckpt}", "--global-batch=8",
                 "--staleness=0"]) == 0
    assert json.loads(capsys.readouterr().out)["requests"] == 3
    for bad in ("--staleness=-2", "--global-batch=-1"):
        with pytest.raises(SystemExit) as e:
            main([*SERVE_FLAGS, f"--ckpt-dir={ckpt}", bad])
        assert e.value.code == 2
