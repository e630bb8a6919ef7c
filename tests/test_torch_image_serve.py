"""Image serving of the port: ``ImageClassifierEngine`` against the JAX
package's, the serve CLI on the image presets, ``POST /v1/classify``, and
the CLI's refusals.

Parameters and BatchNorm running averages are drawn with numpy (flax
shapes from ``jax.eval_shape``, no init compile) and mapped by
``interop``; the images are seeded numpy. Top-k ids must equal the JAX
engine's and the probabilities agree within 1e-5 (f32 convolutions summed
in another order); the draws put no two of the top classes within that.
"""

from __future__ import annotations

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import resnet as jresnet
from distributed_tensorflow_tpu.models.lenet import LeNet5 as JLeNet5
from distributed_tensorflow_tpu.parallel.mesh import build_mesh
from distributed_tensorflow_tpu.serve import ImageClassifierEngine as JaxImageEngine
from distributed_tensorflow_tpu_torch.interop import resnet_params_from_flax
from distributed_tensorflow_tpu_torch.models import LeNet5, ResNet20
from distributed_tensorflow_tpu_torch.serve import ImageClassifierEngine, RequestError


def _variables(init, rng):
    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        if name in ("scale", "var"):
            return 1.0 + 0.2 * np.abs(rng.standard_normal(s.shape))
        return 0.1 * rng.standard_normal(s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda path, s: fill(path, s).astype(np.float32), jax.eval_shape(init))


CASES = {
    "lenet": (JLeNet5, lambda: LeNet5(device="cpu"), (28, 28, 1)),
    "resnet20": (jresnet.ResNet20, lambda: ResNet20(device="cpu", in_channels=3), (16, 16, 3)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_top_k_matches_the_jax_engine(name):
    jfactory, pfactory, shape = CASES[name]
    jnet = jfactory()
    x0 = jnp.zeros((1, *shape))
    variables = _variables(lambda: jnet.init(jax.random.key(0), x0, train=False),
                           np.random.default_rng(1))
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    kw = dict(image_shape=shape, max_batch=4, batch_tiers=(4,), top_k=3)
    jeng = JaxImageEngine(jnet, params, state, mesh, **kw)
    sd, stats = resnet_params_from_flax(params, state.get("batch_stats"))
    peng = ImageClassifierEngine(pfactory(), sd, {"batch_stats": stats} if stats else {},
                                 "cpu", **kw)
    rng = np.random.default_rng(2)
    payloads = [{"image": rng.standard_normal(shape).astype(np.float32)} for _ in range(3)]
    ref, got = jeng.run_batch(payloads), peng.run_batch(payloads)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g["top_ids"], np.asarray(r["top_ids"]))
        np.testing.assert_allclose(g["top_probs"], np.asarray(r["top_probs"]), atol=1e-5)
    with pytest.raises(RequestError, match="engine geometry"):
        peng.validate({"image": np.zeros((3, 3, 1))})
    assert peng.grid_status()["cells_total"] == 1


def _serve_args(ck, *extra):
    from distributed_tensorflow_tpu_torch.cli.serve import make_parser

    return make_parser().parse_args(
        ["--config=cifar_resnet20", f"--ckpt-dir={ck}", "--device=cpu", "--image-size=8",
         "--max-batch=2", "--batch-tiers", "1", "2", *extra])


@pytest.fixture(scope="module")
def image_ckpt(tmp_path_factory):
    """A cifar_resnet20 checkpoint from the train CLI (8x8 images, one
    step), with its BatchNorm statistics."""
    from distributed_tensorflow_tpu_torch.cli.train import main

    ck = tmp_path_factory.mktemp("img") / "ck"
    assert main(["--config=cifar_resnet20", "--device=cpu", "--image-size=8",
                 "--global-batch=8", "--steps=1", "--no-native-input", "--prefetch=0",
                 f"--ckpt-dir={ck}"]) == 0
    return ck


def test_serve_cli_selftest_and_classify_route(image_ckpt, capsys):
    """``cli.serve --config cifar_resnet20 --device cpu --selftest`` from the
    train CLI's checkpoint, then one ``POST /v1/classify``: its top-k is the
    plain eval forward's on the restored params and statistics."""
    from distributed_tensorflow_tpu_torch import ckpt
    from distributed_tensorflow_tpu_torch.cli.serve import PRESETS, build_serving_client, main
    from distributed_tensorflow_tpu_torch.serve import build_http_server

    assert main(["--config=cifar_resnet20", f"--ckpt-dir={image_ckpt}", "--device=cpu",
                 "--image-size=8", "--max-batch=2", "--batch-tiers", "1", "2",
                 "--selftest=3"]) == 0
    assert json.loads(capsys.readouterr().out)["requests"] == 3

    client, _ = build_serving_client(PRESETS["cifar_resnet20"], _serve_args(image_ckpt))
    server = build_http_server(client, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = np.random.default_rng(5).standard_normal((8, 8, 3)).astype(np.float32)
    try:
        req = urllib.request.Request(
            "http://{}:{}/v1/classify".format(*server.server_address),
            data=json.dumps({"image": img.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        client.close()
        thread.join(timeout=5)
    params, state, _ = ckpt.restore_serving_state(image_ckpt)
    model = ResNet20(device="cpu", in_channels=3)
    model.load_state_dict(params)
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(img)[None], state["batch_stats"], train=False)
    want = torch.softmax(logits.float(), -1).topk(5)
    assert body["top_ids"] == want.indices[0].tolist()
    np.testing.assert_allclose(body["top_probs"], want.values[0].numpy(), atol=1e-6)


@pytest.mark.parametrize(
    "argv,message",
    [(["--config=cifar_resnet20", "--weight-dtype=int8"], "not supported for image serving"),
     (["--config=lm_base", "--disagg-role=decode"],
      "--disagg-role decode requires --prefix-cache-mb > 0"),
     (["--config=bert_base", "--kv-dtype=int8"], "only applies to causal-LM decode serving")],
    ids=["image-int8", "lm_base", "decode-flag"],
)
def test_serve_cli_refusals(argv, message, capsys, tmp_path):
    from distributed_tensorflow_tpu_torch.cli.serve import main

    with pytest.raises(SystemExit) as ei:
        main(argv + [f"--ckpt-dir={tmp_path}", "--device=cpu"])
    assert ei.value.code == 2
    assert message in capsys.readouterr().err


def test_serve_cli_bert_int8_selftest(tmp_path, capsys):
    """``--weight-dtype int8`` on bert_base: packed at restore, served."""
    from distributed_tensorflow_tpu_torch import ckpt
    from distributed_tensorflow_tpu_torch.cli.serve import main
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining

    model = BertForPreTraining(BertConfig(vocab_size=64, hidden_size=48, num_layers=1,
                                          intermediate_size=192, max_position=128),
                               device="cpu")
    ckpt.save(tmp_path / "ck", 1, model.state_dict())
    assert main(["--config=bert_base", f"--ckpt-dir={tmp_path / 'ck'}", "--device=cpu",
                 "--bert-layers=1", "--bert-hidden=48", "--bert-vocab=64",
                 "--weight-dtype=int8", "--buckets", "16", "--max-batch=2",
                 "--selftest=2"]) == 0
    assert json.loads(capsys.readouterr().out)["requests"] == 2
