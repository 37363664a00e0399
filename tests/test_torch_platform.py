"""``PCAD_PLATFORM`` (``plantcaduceus_tpu_torch.utils.platform``): ``cpu``
runs a port CLI on the CPU without a device flag, in a fresh interpreter;
``cuda``/``gpu`` pick the card; any other value is refused with a
``ValueError`` naming it; a device flag wins over the variable."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TINY = dict(d_model=16, n_layer=2, vocab_size=16, d_state=4)


def _run(args, env_value, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("PCAD_PLATFORM", None)
    if env_value is not None:
        env["PCAD_PLATFORM"] = env_value
    return subprocess.run([sys.executable, "-m", "plantcaduceus_tpu_torch.cli.pretrain", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_cpu_runs_a_cli_on_the_cpu_without_a_device_flag(tmp_path):
    (tmp_path / "tiny.json").write_text(json.dumps(TINY))
    out = tmp_path / "run"
    res = _run(["--dataset", "synthetic", "--config", str(tmp_path / "tiny.json"), "--window",
                "32", "--batch-size", "4", "--max-steps", "2", "--save-steps", "2",
                "--log-steps", "1", "--output-dir", str(out)], "cpu", tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert (out / "final" / "pytorch_model.bin").is_file() and (out / "2" / "state.pt").is_file()


@pytest.mark.parametrize("value", ["tpu"])
def test_other_platforms_are_refused(value, tmp_path):
    res = _run(["--dataset", "synthetic", "--output-dir", str(tmp_path)], value, tmp_path)
    assert res.returncode != 0
    assert "ValueError" in res.stderr and f"PCAD_PLATFORM='{value}'" in res.stderr


@pytest.mark.parametrize("value,want", [(None, "cuda"), ("", "cuda"), ("cpu", "cpu"),
                                        ("CPU", "cpu"), ("cuda", "cuda"), ("gpu", "cuda")])
def test_default_device_follows_the_variable(value, want, monkeypatch):
    from plantcaduceus_tpu_torch.cli import pretrain
    from plantcaduceus_tpu_torch.utils import platform

    monkeypatch.delenv("PCAD_PLATFORM", raising=False)
    if value is not None:
        monkeypatch.setenv("PCAD_PLATFORM", value)
    assert platform.default_device() == want
    args = ["--dataset", "synthetic", "--output-dir", "x"]
    assert pretrain.parse_args(args).device == want
    assert pretrain.parse_args(args + ["--device", "cpu"]).device == "cpu"   # the flag wins


def test_tpu_refused_with_its_name(monkeypatch):
    from plantcaduceus_tpu_torch.utils import platform

    monkeypatch.setenv("PCAD_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="PCAD_PLATFORM='tpu': the PyTorch port runs on 'cpu' "
                                         "or 'cuda'"):
        platform.maybe_force_platform()
