"""The port's load generator (``tools/loadgen.py`` of the port) on the CPU.

tests/test_serve_loadgen.py's gates, self-serving the port's stack with
``--device cpu``: the closed-loop ``--smoke`` completes every request; an
open loop at twice the closed loop's rate with a short deadline sheds, by
typed reasons only, and drops nothing; ``--report_file`` appends one JSONL
record equal to the last stdout line, with the JAX tool's keys;
``build_shape_plan`` equals the JAX tool's; an unreachable URL drops every
request and exits nonzero; ``--targets`` with ``--stream`` measures SSE
TTFT against a served port stack.
"""

import importlib.util
import json
import threading
from pathlib import Path

import pytest
import torch

from distributed_tensorflow_tpu_torch.cli.serve_lm import build_stack
from distributed_tensorflow_tpu_torch.config import ServeConfig
from distributed_tensorflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from distributed_tensorflow_tpu_torch.tools import loadgen

pytestmark = pytest.mark.torch_port
# Six test workers share the host's cores: one torch thread each, not one per core.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SHAPE = ["--device", "cpu", "--slots", "2", "--seq_len", "32", "--prompt_len", "6",
         "--max_new_tokens", "6", "--report_file", ""]


@pytest.fixture(scope="module")
def jax_loadgen():
    spec = importlib.util.spec_from_file_location("jax_loadgen", ROOT / "tools" / "loadgen.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_closed_loop_smoke_completes_every_request(capsys, jax_loadgen):
    rc = loadgen.main(["--smoke", "--num_requests", "8", "--concurrency", "4", *SHAPE])
    report = _last_json(capsys)
    assert rc == 0 and report["mode"] == "closed"
    assert (report["completed"], report["shed"], report["dropped_without_shed"]) == (8, 0, 0)
    assert report["throughput_tok_s"] > 0
    assert report["ttft_ms"]["p99"] >= report["ttft_ms"]["p50"] > 0
    assert report["recompile_events_total"] == 0
    assert report["serve_spec_accept_rate_by_drafter"].keys() >= {"ngram"}
    assert report["kv_dtype"] == "bf16" and report["weight_dtype"] == "native"


def test_open_loop_2x_overload_sheds_typed(capsys):
    rc = loadgen.main(["--num_requests", "8", "--concurrency", "4", *SHAPE])
    closed = _last_json(capsys)
    assert rc == 0 and closed["completed"] == 8
    rate = 2.0 * closed["completed"] / closed["wall_s"]
    deadline_s = max(1e-3, closed["wall_s"] / 8)
    n = 24
    rc = loadgen.main(["--smoke", "--num_requests", str(n), "--rate", str(rate),
                       "--deadline_s", str(deadline_s), "--kv_dtype", "int8", *SHAPE])
    report = _last_json(capsys)
    assert rc == 0 and report["mode"] == "open" and report["kv_dtype"] == "int8"
    assert report["dropped_without_shed"] == 0
    assert report["completed"] + report["shed"] == n
    assert report["completed"] > 0 and report["shed"] > 0, report
    assert set(report["shed_reasons"]) <= {"deadline", "queue_full"}


def test_report_file_is_one_jsonl_record_with_the_jax_keys(capsys, tmp_path, jax_loadgen,
                                                           monkeypatch):
    path = tmp_path / "lg.jsonl"
    flags = ["--num_requests", "6", "--concurrency", "3", *SHAPE[:-2], "--report_file", str(path)]
    assert loadgen.main([*flags, "--spec_k", "2", "--spec_branches", "2"]) == 0
    record = _last_json(capsys)
    lines = path.read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert record["completed"] == 6 and record["slots"] == 2
    for field in ("ttft_ms", "latency_ms", "intertoken_ms"):
        assert record[field]["p99"] >= record[field]["p95"] >= record[field]["p50"]
    assert loadgen.main([*flags[:1], "2", *flags[2:]]) == 0  # appends, never truncates
    capsys.readouterr()
    assert len(path.read_text().splitlines()) == 2
    # The JAX tool's report, on a dead URL (no JAX engine to build), has
    # the same keys.
    jax_rc = jax_loadgen.main(["--url", "http://127.0.0.1:1", "--num_requests", "1",
                               "--timeout_s", "1", "--report_file", ""])
    assert jax_rc == 0 and set(_last_json(capsys)) == set(record)


def test_shape_plans_equal_the_jax_tool(jax_loadgen):
    assert loadgen.SHAPES == jax_loadgen.SHAPES
    for shape in loadgen.SHAPES:
        for n, rate in ((17, 10.0), (60, 30.0), (5, 2.5)):
            assert loadgen.build_shape_plan(shape, n, rate) == jax_loadgen.build_shape_plan(
                shape, n, rate)
    with pytest.raises(SystemExit):
        loadgen.main(["--shape", "burst", "--num_requests", "4", *SHAPE])


def test_unreachable_url_drops_and_exits_nonzero(capsys):
    rc = loadgen.main(["--smoke", "--url", "http://127.0.0.1:1", "--num_requests", "3",
                       "--concurrency", "3", "--timeout_s", "2", "--report_file", ""])
    report = _last_json(capsys)
    assert rc == 1
    assert report["completed"] == 0 and report["dropped_without_shed"] == 3


def test_streamed_http_load_against_a_served_stack(capsys):
    cfg = TransformerConfig(vocab_size=256, d_model=32, num_heads=4, num_layers=1, d_ff=64,
                            max_seq_len=32)
    serve_cfg = ServeConfig(port=0, slots=2, serve_max_len=32, prefill_len=16, spec_k=2)
    _, sched, _, server = build_stack(serve_cfg, cfg, TransformerLM(cfg, device="cpu"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    sched.start(poll_s=0.001)
    url = "http://%s:%d" % server.server_address
    try:
        rc = loadgen.main(["--smoke", "--targets", f"{url},{url}", "--stream", "--num_requests",
                           "6", "--concurrency", "3", "--prompt_len", "6", "--max_new_tokens",
                           "6", "--report_file", ""])
        report = _last_json(capsys)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
        sched.stop()
    assert rc == 0 and report["stream"] and report["completed"] == 6
    assert report["ttft_ms"]["p50"] > 0 and report["recompile_events_total"] == 0
    assert report["serve_spec_accept_rate"] is not None
