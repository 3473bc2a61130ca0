"""The port's serving stack — scheduler, HTTP server, ``cli/serve_lm.py`` and
``cli/generate.py`` — against the JAX package's, on the CPU in f32.

One bundle exported by the JAX package (vocab 256, so the byte codec is on)
is served by both packages' ``build_stack``; the same requests get the same
status codes, the same JSON keys and, greedy, the same tokens, on
``/generate`` (JSON and SSE), ``/healthz``, ``/metrics``, ``/metrics.json``
and the endpoints of features that are off (``/slo.json``, ``/handoff``,
``/admin/*``). The scheduler scenarios of tests/test_serve_scheduler.py and
tests/test_serve_fairness.py run on the port's engine: admission order,
typed rejections, deadlines, streaming and drain; the lane queue pops in
the JAX queue's order. ``cli/generate.py --device cpu`` gives
``tools/generate.py``'s greedy tokens and ``--text`` round trip on the same
bundle, and ``cli/serve_lm.py --demo --device cpu`` answers and drains on
SIGTERM.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.config import ServeConfig as JaxServeConfig
from distributed_tensorflow_tpu.serve import scheduler as JS
from distributed_tensorflow_tpu.train import checkpoint as JC
from distributed_tensorflow_tpu_torch.cli import generate as gen_cli
from distributed_tensorflow_tpu_torch.cli import serve_lm as serve_cli
from distributed_tensorflow_tpu_torch.config import ServeConfig
from distributed_tensorflow_tpu_torch.models.convert import transformer_params_to_jax
from distributed_tensorflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from distributed_tensorflow_tpu_torch.obs.export import parse_prometheus_text
from distributed_tensorflow_tpu_torch.serve import scheduler as TS
from distributed_tensorflow_tpu_torch.serve.engine import SlotEngine
from distributed_tensorflow_tpu_torch.serve.metrics import ServingMetrics
from distributed_tensorflow_tpu_torch.serve.server import make_server
from distributed_tensorflow_tpu_torch.train.checkpoint import load_lm_bundle
from distributed_tensorflow_tpu_torch.utils import faults

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CONFIG = {"vocab_size": 256, "d_model": 32, "num_heads": 4, "num_kv_heads": 0,
          "attention_window": 0, "use_bias": 1, "rope": 0, "num_layers": 2, "d_ff": 64,
          "max_seq_len": 48}
SERVE = dict(port=0, slots=2, serve_max_len=48, prefill_len=24, max_queue_depth=8,
             request_timeout_s=30.0)


def _post(url, payload, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def _sse(body: bytes):
    """[(event, data)] of an SSE body."""
    out = []
    for frame in body.decode().split("\n\n"):
        if frame.strip():
            lines = dict(line.split(": ", 1) for line in frame.splitlines())
            out.append((lines["event"], json.loads(lines["data"])))
    return out


def _serve(server, sched):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    sched.start(poll_s=0.001)
    host, port = server.server_address
    return f"http://{host}:{port}", thread


def _shut(server, thread, sched):
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)
    sched.stop()


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    # The port draws the weights (no JAX init to compile); the JAX package
    # exports them.
    cfg = TransformerConfig(compute_dtype=torch.float32, vocab_size=256, d_model=32,
                            num_heads=4, num_layers=2, d_ff=64, max_seq_len=48)
    params = transformer_params_to_jax(TransformerLM(cfg, device="cpu"))
    path = str(tmp_path_factory.mktemp("bundle") / "lm.msgpack")
    JC.export_inference_bundle(path, params,
                               metadata={"model": "TransformerLM", "parallelism": "dp",
                                         "config": CONFIG})
    return path


@pytest.fixture(scope="module")
def stacks(bundle):
    """Both packages' build_stack on the bundle, each serving on an
    ephemeral port: {"jax": (base, sched), "port": (base, sched)}."""
    import tools.serve_lm as jax_cli

    jcfg, jparams, _ = JC.load_lm_bundle(bundle)
    jstack = jax_cli.build_stack(JaxServeConfig(slo="off", **SERVE), jcfg, jparams)
    cfg, model, _ = load_lm_bundle(bundle, device="cpu")
    tstack = serve_cli.build_stack(ServeConfig(**SERVE), cfg, model)
    assert tstack[3].sentinel is not None and tstack[3].serving_metrics is tstack[2]
    running = {}
    for name, (_, sched, _, server) in (("jax", jstack), ("port", tstack)):
        base, thread = _serve(server, sched)
        running[name] = (base, sched, server, thread)
    yield {k: (v[0], v[1]) for k, v in running.items()}
    for base, sched, server, thread in running.values():
        _shut(server, thread, sched)


def _both(stacks, fn):
    return fn(stacks["jax"][0]), fn(stacks["port"][0])


def test_generate_json_matches_jax(stacks):
    for payload in ({"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 7, "request_id": "a"},
                    {"prompt": "Hello, world", "max_new_tokens": 5},
                    {"prompt": list(range(40)), "max_new_tokens": 6}):  # chunked prefill
        want, got = _both(stacks, lambda b: _post(b + "/generate", payload))
        assert got[0] == want[0] == 200
        jw, jg = json.loads(want[2]), json.loads(got[2])
        assert sorted(jg) == sorted(jw)
        assert jg["tokens"] == jw["tokens"] and jg.get("text") == jw.get("text")
        assert jg["finish_reason"] == jw["finish_reason"] == "length"
        assert jg["ttft_ms"] > 0 and jg["latency_ms"] >= jg["ttft_ms"]
        assert got[1]["X-Variant"] == want[1]["X-Variant"]


def test_sse_stream_matches_jax(stacks):
    payload = {"prompt": [7, 8, 9], "max_new_tokens": 6, "stream": True}
    want, got = _both(stacks, lambda b: _post(b + "/generate", payload))
    assert got[0] == want[0] == 200
    assert got[1]["Content-Type"] == want[1]["Content-Type"] == "text/event-stream"
    ev_w, ev_g = _sse(want[2]), _sse(got[2])
    assert [e for e, _ in ev_g][-1] == "done" and {e for e, _ in ev_g[:-1]} == {"token"}
    streamed = [t for e, d in ev_g if e == "token" for t in d["tokens"]]
    assert streamed == ev_g[-1][1]["tokens"] == ev_w[-1][1]["tokens"]
    assert sorted(ev_g[-1][1]) == sorted(ev_w[-1][1])


def test_rejections_match_jax(stacks):
    cases = [{"prompt": []}, {"prompt": [1, "a"]}, {"prompt": [1], "max_new_tokens": 0},
             {"prompt": list(range(48)), "max_new_tokens": 2}, {"prompt": [1], "deadline_s": -2},
             {"prompt": [1], "priority": 3}, {"prompt": [1], "variant": "b"}]
    for payload in cases:
        want, got = _both(stacks, lambda b: _post(b + "/generate", payload))
        jw, jg = json.loads(want[2]), json.loads(got[2])
        assert (got[0], jg["error"]) == (want[0], jw["error"]) == (400, "invalid"), payload
        assert sorted(jg) == sorted(jw)
    want, got = _both(stacks, lambda b: _get(b + "/nope"))
    assert got[0] == want[0] == 404 and json.loads(got[2]) == json.loads(want[2])


def test_healthz_and_metrics_match_jax(stacks):
    want, got = _both(stacks, lambda b: _get(b + "/healthz"))
    jw, jg = json.loads(want[2]), json.loads(got[2])
    assert got[0] == want[0] == 200 and jg["ok"] is True
    assert sorted(jg) == sorted(jw) and sorted(jg["deploy"]) == sorted(jw["deploy"])
    for key in ("slots", "pages_total", "mesh", "weight_dtype", "kv_dtype", "role"):
        assert jg[key] == jw[key], key
    want, got = _both(stacks, lambda b: _get(b + "/metrics.json"))
    assert got[0] == want[0] == 200
    assert sorted(json.loads(got[2])) == sorted(json.loads(want[2]))
    want, got = _both(stacks, lambda b: _get(b + "/metrics"))
    assert got[0] == want[0] == 200
    assert got[1]["Content-Type"] == want[1]["Content-Type"]
    names = lambda text: {s["name"] for s in parse_prometheus_text(text.decode())}
    assert names(got[2]) == names(want[2])
    samples = {s["name"]: s["value"] for s in parse_prometheus_text(got[2].decode())}
    assert samples["serve_completed_total"] >= 1 and samples["recompile_events_total"] == 0


def test_feature_off_endpoints_match_jax(stacks):
    for path in ("/slo.json",):
        want, got = _both(stacks, lambda b: _get(b + path))
        assert (got[0], json.loads(got[2])) == (want[0], json.loads(want[2]))
    # The JAX scheduler always takes decode-tier imports; its server's answer
    # for a scheduler without them (server.py, _handle_handoff) is this:
    status, _, body = _post(stacks["port"][0] + "/handoff", {})
    assert (status, json.loads(body)) == (404, {"error": "not_found",
                                                "detail": "no handoff support"})
    for path, payload in (("/admin/handoff_peers", {"urls": []}),
                          ("/admin/deploy", {}), ("/admin/deploy", {"canary_percent": 5}),
                          ("/admin/deploy", {"step": 1, "watch_dir": "/nonexistent"})):
        want, got = _both(stacks, lambda b: _post(b + path, payload))
        assert (got[0], json.loads(got[2])) == (want[0], json.loads(want[2])), path


def test_fault_sites(stacks):
    base = stacks["port"][0]
    faults.configure("replica_5xx")
    try:
        status, headers, body = _post(base + "/generate", {"prompt": [1], "max_new_tokens": 2})
        assert (status, json.loads(body)["error"], headers["Retry-After"]) == (
            503, "injected_5xx", "1")
        faults.configure("stream_cut:after=1")
        status, _, body = _post(base + "/generate",
                                {"prompt": [1, 2], "max_new_tokens": 6, "stream": True})
        events = _sse(body)
        assert status == 200 and [e for e, _ in events] == ["token"]  # cut: no done frame
        faults.configure("replica_stall:ms=50")
        assert faults.delay_s("replica_stall") == 0.05 == faults.delay_s("replica_stall")
    finally:
        faults.reset()
    with pytest.raises(ValueError):
        faults.parse_spec("x:p=0.5")


# -- the scheduler on the port's engine ------------------------------------


@pytest.fixture(scope="module")
def model(bundle):
    return load_lm_bundle(bundle, device="cpu")


def _engine(model, slots=2):
    cfg, m, _ = model
    return SlotEngine(cfg, m, slots=slots, max_len=48, prefill_len=12, device="cpu")


def test_fcfs_refill_and_accounting(model):
    metrics = ServingMetrics()
    sched = TS.Scheduler(_engine(model, slots=1), max_queue_depth=8, metrics=metrics)
    handles = [sched.submit(TS.Request(prompt=(i + 1, 2, 3), max_new_tokens=3,
                                       request_id=f"r{i}")) for i in range(4)]
    assert sched.run_until_idle(max_steps=200) == 4
    outs = [h.result(timeout=1) for h in handles]
    assert all(isinstance(o, TS.Completion) and len(o.tokens) == 3 for o in outs)
    ttfts = [o.ttft_s for o in outs]
    assert ttfts == sorted(ttfts)
    snap = metrics.snapshot()
    # tokens_out counts decode rounds' tokens: each first token comes from prefill.
    assert snap["completed"] == 4 and snap["tokens_out"] == 8 and snap["shed"] == 0


def test_typed_rejections_and_deadlines(model):
    now = [0.0]
    sched = TS.Scheduler(_engine(model, slots=1), max_queue_depth=2, clock=lambda: now[0])
    bad = sched.submit(TS.Request(prompt=(), max_new_tokens=2)).result(timeout=1)
    assert isinstance(bad, TS.Rejection) and bad.reason == "invalid"
    keep = sched.submit(TS.Request(prompt=(1,), max_new_tokens=2))
    late = sched.submit(TS.Request(prompt=(2,), max_new_tokens=2, deadline_s=0.5))
    full = sched.submit(TS.Request(prompt=(3,), max_new_tokens=2)).result(timeout=1)
    assert full.reason == "queue_full"
    now[0] = 1.0
    sched.run_until_idle(max_steps=100)
    assert isinstance(keep.result(timeout=1), TS.Completion)
    assert late.result(timeout=1).reason == "deadline"
    queued = sched.submit(TS.Request(prompt=(4,), max_new_tokens=2))
    sched.begin_drain(5.0)
    assert sched.submit(TS.Request(prompt=(5,))).result(timeout=1).reason == "shutting_down"
    assert sched.drain_remaining_s() == 5.0
    sched.stop()
    assert queued.result(timeout=1).reason == "shutting_down"
    with pytest.raises(TimeoutError):
        TS.Scheduler(_engine(model)).submit(TS.Request(prompt=(1,))).result(timeout=0.05)


def test_lanes_and_clients_pop_in_the_jax_order():
    rng = np.random.default_rng(0)
    reqs = [(int(rng.integers(0, 3)), f"c{int(rng.integers(0, 3))}") for _ in range(40)]
    orders = []
    for mod in (JS, TS):
        q = mod._FairQueue(client_weights={"c0": 2.0})
        for i, (lane, cid) in enumerate(reqs):
            q.push(mod.PendingRequest(mod.Request(prompt=(1,), priority=lane, client_id=cid,
                                                  request_id=str(i)), 0.0))
        orders.append([q.pop().request.request_id for _ in range(len(reqs))])
    assert orders[0] == orders[1]


def test_priority_streaming_and_background_loop(model):
    sched = TS.Scheduler(_engine(model, slots=1), max_queue_depth=16)
    batch = [sched.submit(TS.Request(prompt=(1, 2), max_new_tokens=2, priority=2))
             for _ in range(2)]
    inter = [sched.submit(TS.Request(prompt=(3, 4), max_new_tokens=2, priority=0))
             for _ in range(2)]
    stream = sched.submit(TS.Request(prompt=(1, 2, 3), max_new_tokens=5, stream=True))
    sched.start(poll_s=0.001)
    try:
        events = list(stream.stream_events(timeout=30))
        assert [k for k, _ in events][-1] == "done" and len(events) > 1
        streamed = [t for k, p in events if k == "tokens" for t in p]
        assert tuple(streamed) == events[-1][1].tokens and len(streamed) == 5
        ttft = lambda hs: [h.result(timeout=30).ttft_s for h in hs]
        assert max(ttft(inter)) < min(ttft(batch))
    finally:
        sched.stop()
    rejected = TS.Scheduler(_engine(model)).submit(TS.Request(prompt=(), stream=True))
    assert [k for k, _ in rejected.stream_events(timeout=1)] == ["done"]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TS.Scheduler(_engine(model), role="prefill")


def test_queue_full_and_drain_over_http(model):
    sched = TS.Scheduler(_engine(model, slots=1), max_queue_depth=1)
    server = make_server(sched, port=0, request_timeout_s=30.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address
    try:
        sched.submit(TS.Request(prompt=(1,), max_new_tokens=2))  # fills the queue
        status, headers, body = _post(base + "/generate", {"prompt": [2], "max_new_tokens": 2})
        assert (status, json.loads(body)["error"], headers["Retry-After"]) == (
            429, "queue_full", "1")
        sched.begin_drain(3.0)
        status, headers, body = _post(base + "/generate", {"prompt": [2]})
        body = json.loads(body)
        assert (status, body["error"]) == (503, "shutting_down")
        assert 0 < body["drain_deadline_s"] <= 3.0 and int(headers["Retry-After"]) >= 1
        status, _, body = _get(base + "/healthz")
        assert status == 503 and json.loads(body)["draining"] is True
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
        sched.stop()


# -- the CLIs ----------------------------------------------------------------


def test_generate_cli_matches_jax_tool(bundle, capsys):
    import tools.generate as jax_gen

    for flags in (["--prompt", "7,8,9,10"], ["--text", "Hello", "--max_new_tokens", "6"]):
        want = jax_gen.main(["--model", bundle, *flags])
        jax_out = capsys.readouterr().out
        got = gen_cli.main(["--model", bundle, "--device", "cpu", *flags])
        port_out = capsys.readouterr().out
        np.testing.assert_array_equal(got, np.asarray(want))
        assert port_out == jax_out  # the printed prompt and output (text decoded)
    sampled = ["--model", bundle, "--device", "cpu", "--temperature", "0.9", "--top_k", "8",
               "--seed", "3"]
    np.testing.assert_array_equal(gen_cli.main(sampled), gen_cli.main(sampled))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gen_cli.main(["--model", bundle])


@pytest.mark.parametrize("flags", [
    ["--role", "decode"], ["--handoff_peers", "http://x"], ["--slo_interval_s", "5"],
    ["--serve_log_dir", "x"], ["--deploy_variant", "b"], ["--tp", "2"], ["--watch_dir", "x"],
    ["--role", "prefill"], ["--slo", "default"], ["--obs_dir", "x"],
])
def test_serve_cli_refuses_flags_of_later_slices(flags, capsys):
    with pytest.raises(SystemExit):
        serve_cli.parse_args(flags)
    assert "not ported yet" in capsys.readouterr().err


def test_serve_cli_takes_the_deployed_flags(bundle):
    """--weight_dtype/--quant, --quant_group_size, --kv_dtype, --spec_k,
    --spec_branches and --draft_model: the stack quantizes the target and
    the drafter (int4) on the fly, pages int8 KV, drafts with the model, and
    a greedy request's tokens equal those of a plain engine on the same
    quantized model."""
    for flags in (["--quant", "int8"], ["--spec_k", "2", "--spec_branches", "3"],
                  ["--kv_dtype", "bf16"]):
        serve_cli.parse_args(flags)
    args, scfg = serve_cli.parse_args([
        "--weight_dtype", "int4", "--quant_group_size", "16", "--kv_dtype", "int8",
        "--spec_k", "3", "--draft_model", bundle, "--draft_window", "8", "--port", "0",
        "--slots", "2", "--serve_max_len", "48", "--prefill_len", "24"])
    cfg, model, _ = load_lm_bundle(bundle, device="cpu")
    engine, sched, metrics, server = serve_cli.build_stack(scfg, cfg, model)
    server.server_close()
    assert (engine.weight_dtype, engine.draft_weight_dtype, engine.kv_dtype) == (
        "int4", "int4", "int8")
    assert engine.drafter == "model" and engine.spec_k == 3 and engine.draft_window == 8
    sched.start(poll_s=0.001)
    try:
        done = sched.submit(TS.Request(prompt=(5, 6, 7, 5, 6), max_new_tokens=10)).result(
            timeout=30)
    finally:
        sched.stop()
    plain = SlotEngine(engine.cfg, engine.model, slots=1, max_len=48, prefill_len=24,
                       device="cpu")
    slot = plain.acquire_slot()
    toks = [plain.start(slot, [5, 6, 7, 5, 6], max_new_tokens=10)[0]]
    while len(toks) < 10:
        t, v, _ = plain.step()
        toks += [int(x) for x in t[v[:, slot], slot]]
    assert list(done.tokens) == toks
    assert metrics.snapshot()["weight_dtype"] == "int4"


def test_serve_cli_demo_serves_and_drains_on_sigterm():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.serve_lm", "--demo",
         "--device", "cpu", "--port", "0", "--d_model", "32", "--num_layers", "1",
         "--d_ff", "64", "--seq_len", "32", "--slots", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), line
        base = line.split()[2]
        status, _, body = _post(base + "/generate", {"prompt": "hi", "max_new_tokens": 3})
        assert status == 200 and len(json.loads(body)["tokens"]) == 3
        assert "text" in json.loads(body)
        assert _get(base + "/healthz")[0] == 200
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "shut down cleanly" in out
