#!/usr/bin/env bash
# Full verification harness (counterpart of the reference's
# scripts/run_all_tests.sh): unit/parity tests, CLI smoke tests asserting a
# RIFF WAV is produced, golden generation + e2e comparison, and the
# multi-device sharding tests. Runs on the CPU (virtual 8-device mesh; no
# checkpoints required — synthetic weights at tiny config keep it fast).
# On a GPU machine, `python chip_smoke.py` is the on-card counterpart.
set -u
cd "$(dirname "$0")/.."

PASS=0; FAIL=0
section() { echo; echo "=== $1 ==="; }
check() { if "$@"; then PASS=$((PASS+1)); else FAIL=$((FAIL+1)); echo "FAILED: $*"; fi; }

export JAX_PLATFORMS=cpu
export XLA_FLAGS="${XLA_FLAGS:-} --xla_force_host_platform_device_count=8"

section "0. quick tier (fast green signal, <5 min)"
check python -m pytest tests/ -m quick -q

section "1. unit + parity tests (full)"
check python -m pytest tests/ -q

section "2. CLI smoke tests (synthetic tiny run, WAV must be RIFF)"
TMP=$(mktemp -d)
check python - <<EOF
import jax; jax.config.update("jax_platforms", "cpu")
from qwen3tts_tpu.config import tiny_pipeline_config, SamplingConfig
from qwen3tts_tpu.pipeline import Qwen3TTS, save_wav
tts = Qwen3TTS(tiny_pipeline_config())
assert tts.load_models(synthetic=True)
for name, params in [
    ("basic", SamplingConfig(temperature=0.0, top_k=0, max_audio_tokens=8)),
    ("sampled", SamplingConfig(temperature=0.9, top_k=50, max_audio_tokens=8)),
]:
    r = tts.synthesize("Hello there.", params)
    assert r.success, r.error_msg
    save_wav("$TMP/" + name + ".wav", r.audio, r.sample_rate)
import numpy as np
r2 = tts.synthesize_with_voice("Hello.", np.zeros(600, np.float32),
                               SamplingConfig(temperature=0.0, top_k=0, max_audio_tokens=8))
assert r2.success, r2.error_msg
save_wav("$TMP/clone.wav", r2.audio, r2.sample_rate)
EOF
for f in basic sampled clone; do
  check bash -c "head -c4 $TMP/$f.wav | grep -q RIFF"
done

section "3. golden fixtures + e2e gates (tiny synthetic)"
check python tools/make_goldens.py --tiny --synthetic --seed 3 --max-frames 8 --out "$TMP/goldens"
check python tools/compare_e2e.py --tiny --synthetic --seed 3 --goldens "$TMP/goldens"

section "4. GGUF conversion roundtrip"
check python -m pytest tests/test_io.py -q

section "5. multi-device sharding (8 virtual devices)"
check python -m pytest tests/test_parallel.py -q

echo
echo "=== run_all_tests: $PASS passed, $FAIL failed ==="
rm -rf "$TMP"
exit $((FAIL > 0))
