"""chip_smoke.py: its refusals, the shape of its last line, and each phase
rehearsed at tiny widths on the CPU (the kernel in interpret mode)."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from qwen3tts_tpu.config import tiny_pipeline_config  # noqa: E402

TINY = tiny_pipeline_config()


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def _no_result(stdout: str) -> bool:
    return not any(line.lstrip().startswith("{") for line in stdout.splitlines())


@pytest.mark.parametrize("args", [(), ("--four",)])
def test_refuses_a_cpu_backend(args):
    proc = _run_script(REPO, *args)
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr
    assert _no_result(proc.stdout)


def test_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path))
    assert proc.returncode != 0
    assert _no_result(proc.stdout)


def _fake_gpu(monkeypatch):
    from qwen3tts_tpu.utils import device

    monkeypatch.setattr(device, "require_gpu", lambda prog: None)
    monkeypatch.setattr(device, "gpu_name_and_power_limit",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(device, "describe", lambda: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})


def test_last_line_is_the_result_object(monkeypatch, capsys):
    _fake_gpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, "phase_kernel", lambda: None)
    assert chip_smoke.main(["--phases", "kernel"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("nvidia-smi: NVIDIA H100")
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_a_failing_phase_fails_the_run(monkeypatch, capsys):
    _fake_gpu(monkeypatch)

    def boom():
        raise AssertionError("kernel != reference")

    monkeypatch.setattr(chip_smoke, "phase_kernel", boom)
    assert chip_smoke.main(["--phases", "kernel"]) == 1
    assert _no_result(capsys.readouterr().out)


def test_kernel_phase_interpret():
    chip_smoke.phase_kernel(L=2, Hq=4, Hkv=2, D=32, C=128, lanes=2,
                            block_k=16, interpret=True)


def test_parity_phase_tiny():
    chip_smoke.phase_parity(TINY, n_steps=3, capacity=64, vocoder_frames=8)


def test_teacher_forced_logits_match_the_decode_loop_step():
    """teacher_forced_logits' first row is the prefill's logits."""
    import jax
    import jax.numpy as jnp

    from qwen3tts_tpu.models import talker as T

    tcfg = TINY.talker
    tp = T.init_talker_params(jax.random.PRNGKey(0), tcfg, jnp.float32)
    pre = jax.random.normal(jax.random.PRNGKey(1), (10, tcfg.hidden_size))
    steps = jax.random.normal(jax.random.PRNGKey(2), (2, tcfg.hidden_size))
    got = chip_smoke.teacher_forced_logits(tp, tcfg, pre, steps, 32)
    _, want, _ = T.talker_prefill(tp, tcfg, pre, T.make_kv_cache(tcfg, 32, jnp.float32))
    assert got.shape == (3, tcfg.codec_vocab_size)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_main_path_phase_tiny(monkeypatch):
    """The whole user path at tiny widths, the CLI included (its config
    loader is pointed at the tiny config)."""
    from qwen3tts_tpu.io import config_io

    def tiny_config(model_dir, runtime):
        return dataclasses.replace(TINY, runtime=dataclasses.replace(
            TINY.runtime, dtype=runtime.dtype, quant=runtime.quant))

    monkeypatch.setattr(config_io, "config_from_model_dir", tiny_config)
    chip_smoke.phase_main_path(TINY, long_frames=32, short_frames=16, lanes=4,
                               queue_frames=8, voice_seconds=0.03)


def test_four_card_phase_on_virtual_devices():
    chip_smoke.phase_four(TINY, n_devices=4, lanes_per_card=1, max_frames=6,
                          queue_requests=5)
