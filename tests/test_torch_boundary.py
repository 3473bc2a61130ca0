"""The port's boundary: it imports neither JAX nor the JAX package, runs on
the card unless asked for the CPU, and launches no kernel for CPU tensors."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from distributed_tensorflow_tpu_torch.cli import train_lm as cli
from distributed_tensorflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from distributed_tensorflow_tpu_torch.ops import attention as TA
from distributed_tensorflow_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "distributed_tensorflow_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', "
        "'optax', 'distributed_tensorflow_tpu.')) or m == 'distributed_tensorflow_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_port_tools_import_no_root_tools_or_bench():
    # The port's probes are counterparts of the repo root's tools/*_probe.py,
    # which import bench and the JAX package; the port keeps its own copies.
    mods = [m for m in _modules() if m.startswith("distributed_tensorflow_tpu_torch.tools")]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('tools', 'bench'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert len(mods) == 3, mods
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b|distributed_tensorflow_tpu\.",
                         re.M)
    files = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)}: {hits}"


def test_cli_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--training_steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_model_is_built_on_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = TransformerConfig(vocab_size=16, d_model=16, num_heads=2, num_layers=1, d_ff=16,
                            max_seq_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(cfg)
    assert next(TransformerLM(cfg, device="cpu").parameters()).device.type == "cpu"


def test_cpu_tensors_launch_no_kernel():
    before = dict(TA.KERNEL_LAUNCHES)
    qkv = torch.randn(1, 16, 3 * 2 * 64, requires_grad=True)
    TA.flash_attention_qkv(qkv, 2, causal=True).sum().backward()
    q, k, v = (torch.randn(1, 2, 16, 64, requires_grad=True) for _ in range(3))
    TA.flash_attention(q, k, v, causal=True).sum().backward()
    qs, ks, vs = (torch.randn(1, 16, 2, 64, requires_grad=True) for _ in range(3))
    TA.flash_attention_bshd(qs, ks, vs, causal=True).sum().backward()
    assert qkv.grad is not None and q.grad is not None and qs.grad is not None
    assert TA.KERNEL_LAUNCHES == before == {
        "flash_fwd": 0, "flash_bwd": 0, "bhsd_fwd": 0, "bhsd_bwd": 0,
        "bshd_fwd": 0, "bshd_bwd": 0, "bwd_dq": 0, "bwd_dkv": 0,
        "pipe_fwd": 0, "probe_bshd_fwd": 0,
    }
