"""chip_smoke.py's contract pieces that do not need the card: it refuses a
non-GPU device, prints no result then, builds the exact last line, reads the
flat config files, and keeps optional packages off its import path."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


class Dev:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(jax.devices())
    assert "needs a GPU" in str(e.value.code)


def test_main_on_cpu_exits_nonzero_without_result(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("n", [1, 4])
def test_result_line_is_the_exact_contract(n):
    devs = [Dev("gpu", "NVIDIA H100 80GB HBM3")] * n
    line = chip_smoke.result_line(devs)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": n}}
    assert "\n" not in line


def test_alone_without_the_repo_fails(tmp_path):
    """Copied into an empty directory, the script cannot import the library
    and exits non-zero with no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_read_config_matches_yaml_widths():
    from otto_tpu.config import SGNSConfig, SequenceModelConfig

    ft = SGNSConfig.from_dict(chip_smoke.read_config("fasttext"))
    assert (ft.dim, ft.window, ft.negatives, ft.batch_centers) == (32, 10, 40, 8192)
    assert ft.subsample_t == 1e-4
    seq = SequenceModelConfig.from_dict(chip_smoke.read_config("sequence_transformer"))
    assert (seq.architecture, seq.dim, seq.n_layers, seq.n_heads) == ("transformer", 64, 2, 2)


def test_import_path_keeps_optional_packages_lazy():
    code = (
        "import sys, chip_smoke\n"
        "import otto_tpu.twostage, otto_tpu.eval.oracle, otto_tpu.parallel.serving\n"
        "import otto_tpu.models.sequence, otto_tpu.parallel.data_parallel\n"
        "bad = [m for m in ('pyarrow', 'yaml', 'orbax', 'pandas', 'sklearn', 'torch')\n"
        "       if m in sys.modules]\n"
        "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
