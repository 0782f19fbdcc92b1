"""Serving surface of the PyTorch port: checkpoints written by the JAX
package load bit-equal (and a corrupted payload is refused), the port's
engine answers ``/infer`` over real HTTP with the JAX engine's tokens for the
same snapshot, ``python -m paddle_tpu_torch serve --device cpu`` starts and
serves (paged, slab, and paged with sampling), and nothing runs on the CPU
unless asked to."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.io import checkpoint as jckpt
from paddle_tpu.models import transformer as jtr
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu_torch.io import checkpoint as tckpt
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.serving import InferenceEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, MAXLEN, DIM, HEADS, LAYERS = 64, 96, 32, 2, 2
PAGED = dict(max_slots=2, block_size=8, step_buckets=(2,),
             chunk_buckets=(8, 16))
PROMPTS = [[3, 1, 4, 1, 5], list(range(1, 20)), [9] * 12]
MAX_TOKENS = [6, 4, 5]


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    """A JAX LM and its parameters saved by the JAX checkpoint writer."""
    paddle.init(seed=0)
    cost, _ = jtr.build(vocab_size=VOCAB, max_len=MAXLEN, dim=DIM,
                        num_heads=HEADS, num_layers=LAYERS)
    topo = paddle.Topology(cost, collect_evaluators=False)
    params = paddle.parameters.create(topo)
    d = str(tmp_path_factory.mktemp("ckpt"))
    jckpt.save(d, 0, trainable=params.values, opt_state={}, model_state={})
    return topo, params, d


def _post(url, doc, raw=None):
    req = urllib.request.Request(
        url + "/infer", data=raw if raw is not None else
        json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return r.status, r.read()


def _port_engine(d, **kw):
    model = ttr.params_from_jax(tckpt.params_of(tckpt.load(d)),
                                num_heads=HEADS)
    return InferenceEngine(ttr.PagedDecoder(model, device="cpu",
                                            **dict(PAGED, **kw)))


def _jax_tokens(snap):
    topo, params, _ = snap
    eng = JaxEngine(decoder=jtr.PagedDecoder(topo, params,
                                             decode_kernel="xla", **PAGED))
    try:
        futs = [eng.submit([p], max_tokens=m)
                for p, m in zip(PROMPTS, MAX_TOKENS)]
        return [f.result(120).tolist() for f in futs]
    finally:
        eng.close()


def test_jax_snapshot_loads_bit_equal_and_corruption_is_refused(snap,
                                                                tmp_path):
    _, params, d = snap
    got = tckpt.load(d)
    assert os.path.basename(got["dir"]) == "pass-00000"
    for layer, ps in params.values.items():
        for name, arr in ps.items():
            np.testing.assert_array_equal(got["trainable"][layer][name],
                                          np.asarray(arr))
    # the port's writer produces a snapshot the JAX loader reads back
    out = str(tmp_path / "port")
    tckpt.save_params(out, got["trainable"], pass_id=3)
    back = jckpt.load(out)
    for layer, ps in got["trainable"].items():
        for name, arr in ps.items():
            np.testing.assert_array_equal(back["trainable"][layer][name],
                                          arr)
    # flip one payload byte: the checksum refuses it
    bad = str(tmp_path / "bad")
    tckpt.save_params(bad, got["trainable"])
    path = os.path.join(bad, "pass-00000", "params.npz")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(tckpt.CheckpointCorrupt, match="SHA-256"):
        tckpt.load(bad)


def test_http_infer_matches_jax_engine(snap):
    want = _jax_tokens(snap)
    eng = _port_engine(snap[2])
    try:
        url = f"http://127.0.0.1:{eng.serve(0).server_address[1]}"
        results = [None] * len(PROMPTS)

        def call(i):
            results[i] = _post(url, {"input": [PROMPTS[i]],
                                     "max_tokens": MAX_TOKENS[i]})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        for (code, body, _), toks, m in zip(results, want, MAX_TOKENS):
            assert code == 200
            assert body == {"outputs": {"tokens": toks}, "generated": m,
                            "model_version": "boot"}
        assert _get(url, "/healthz") == (200, b"ok\n")
        code, raw = _get(url, "/stats")
        stats = json.loads(raw)
        assert stats["requests"] == len(PROMPTS)
        assert stats["iterations"] > 0 and stats["tokens"] > 0
        kernels = json.loads(_get(url, "/kernels")[1])
        assert kernels["device"] == "cpu"
        assert set(kernels["launches"]) == {"flash_fwd", "flash_bwd_dkdv",
                                         "flash_bwd_dq", "paged_decode",
                                         "lstm_step", "gru_step",
                                         "bn_fwd_stats", "bn_bwd_stats",
                                         "matmul_stats", "conv3x3_stats",
                                         "flash_variants", "flash_fwd_bf16",
                                         "flash_bwd_dkdv_bf16",
                                         "flash_bwd_dq_bf16",
                                         "lstm_step_bf16", "gru_step_bf16",
                                         "bn_fwd_stats_bf16",
                                         "bn_bwd_stats_bf16",
                                         "matmul_stats_bf16",
                                         "conv3x3_stats_bf16",
                                         "flash_fwd_f16",
                                         "flash_bwd_dkdv_f16",
                                         "flash_bwd_dq_f16",
                                         "lstm_step_f16", "gru_step_f16",
                                         "bn_fwd_stats_f16",
                                         "bn_bwd_stats_f16",
                                         "matmul_stats_f16",
                                         "conv3x3_stats_f16"}
        assert stats["decode"]["blocks_used"] == 0   # every block returned
        assert _post(url, None, raw=b"{not json")[0] == 400
        assert _post(url, {"inputs": [[1]]})[0] == 400
        assert _post(url, {"input": [[1, 2]], "max_tokens": 500})[0] == 400
        # a deadline that passes before admission: 504, nothing held
        code, body, _ = _post(url, {"input": [[1, 2]], "max_tokens": 30,
                                    "deadline_ms": 0.001})
        assert code == 504 and "deadline" in body["error"]
        assert json.loads(_get(url, "/stats")[1])["shed"]["deadline"] == 1
    finally:
        eng.close()


def test_dry_pool_answers_429_kv_blocks(snap):
    eng = _port_engine(snap[2], num_blocks=3)  # 2 usable blocks of 8
    try:
        url = f"http://127.0.0.1:{eng.serve(0).server_address[1]}"
        code, body, headers = _post(url, {"input": [list(range(30))],
                                          "max_tokens": 2})
        assert code == 429
        assert body["reason"] == "kv_blocks"
        assert int(headers["Retry-After"]) >= 1
        # the engine keeps serving what fits
        code, body, _ = _post(url, {"input": [[1, 2, 3]], "max_tokens": 2})
        assert code == 200 and body["generated"] == 2
    finally:
        eng.close()


def _cli_serve(snap, *flags):
    """``python -m paddle_tpu_torch serve`` in a subprocess on the CPU:
    (process, ready record)."""
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", "--params",
         snap[2], "--num_heads", str(HEADS), "--decode", *flags,
         "--max_slots", "2", "--device", "cpu", "--port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    for line in proc.stdout:
        if line.startswith('{"ptpu_serve"'):
            return proc, json.loads(line)["ptpu_serve"]
    proc.terminate()
    raise AssertionError(proc.communicate(timeout=30)[1])


def test_cli_serve_subprocess(snap):
    """The paged server, the slab server (``--decode`` alone) and the
    paged server with ``--sampling`` each answer the JAX engine's greedy
    tokens; the sampling server's seeded stream repeats."""
    want = _jax_tokens(snap)[0]
    runs = (("--paged_kv", "--kv_block_size", "8"), (),
            ("--paged_kv", "--kv_block_size", "8", "--sampling",
             "--tenant_weights", "a=3,b=1", "--max_queue_depth", "8"))
    for flags in runs:
        proc, ready = _cli_serve(snap, *flags)
        try:
            assert ready["device"] == "cpu"
            assert ready["paged"] == ("--paged_kv" in flags)
            assert ready["sampling"] == ("--sampling" in flags)
            code, body, _ = _post(ready["url"],
                                  {"input": [PROMPTS[0]],
                                   "max_tokens": MAX_TOKENS[0],
                                   "tenant": "a"})
            assert code == 200
            assert body["outputs"]["tokens"] == want
            doc = {"input": [PROMPTS[0]], "max_tokens": MAX_TOKENS[0],
                   "temperature": 0.9, "seed": 3}
            code, body, _ = _post(ready["url"], doc)
            if "--sampling" in flags:
                assert code == 200
                assert _post(ready["url"], doc)[1] == body
            else:
                assert code == 400 and "sampling" in body["error"]
        finally:
            proc.terminate()
            proc.communicate(timeout=30)


def test_cli_serve_decode_from_model_config(snap, tmp_path):
    """``serve --model cfg.py --decode`` as the JAX command line has it:
    the heads come from the config's graph (no ``--num_heads``), the
    weights from the snapshot; the paged server answers the JAX engine's
    greedy tokens and reports the snapshot's model version."""
    cfg = tmp_path / "lm_cfg.py"
    cfg.write_text(
        "from paddle_tpu_torch.models import transformer\n"
        f"cost, _ = transformer.build(vocab_size={VOCAB}, "
        f"max_len={MAXLEN}, dim={DIM}, num_heads={HEADS}, "
        f"num_layers={LAYERS})\n"
        "prediction = cost\n")
    want = _jax_tokens(snap)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", "--model",
         str(cfg), "--params", snap[2], "--decode", "--paged_kv",
         "--kv_block_size", "8", "--max_slots", "2", "--device", "cpu",
         "--port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ready = None
    for line in proc.stdout:
        if line.startswith('{"ptpu_serve"'):
            ready = json.loads(line)["ptpu_serve"]
            break
    try:
        assert ready is not None, proc.communicate(timeout=30)[1]
        assert ready["decode"] and ready["paged"]
        version = tckpt.snapshot_version(tckpt.load(snap[2])["manifest"])
        assert ready["model_version"] == version
        for p, m, toks in zip(PROMPTS, MAX_TOKENS, want):
            code, body, _ = _post(ready["url"], {"input": [p],
                                                 "max_tokens": m})
            assert code == 200 and body["outputs"]["tokens"] == toks
            assert body["model_version"] == version
    finally:
        proc.terminate()
        proc.communicate(timeout=30)


def test_no_card_means_no_silent_cpu_run(snap):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = ttr.params_from_jax(tckpt.params_of(tckpt.load(snap[2])),
                                num_heads=HEADS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.PagedDecoder(model, **PAGED)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.SlotDecoder(model, max_slots=2)
