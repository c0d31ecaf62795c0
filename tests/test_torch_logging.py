"""``LOG_LEVEL`` in both packages: the first logger a module asks for sets
up root logging at that level, in the JAX package's format. Each case runs
in a fresh interpreter, since the setup happens once a process."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# a module of each package that takes its logger at import
PROBE = "import {pkg}.tasks as m; m.logger.info('probe line at info'); m.logger.warning('probe line at warning')"


def _stderr(pkg: str, level: str | None) -> str:
    env = {k: v for k, v in os.environ.items() if k != "LOG_LEVEL"}
    if level is not None:
        env["LOG_LEVEL"] = level
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.run([sys.executable, "-c", PROBE.format(pkg=pkg)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stderr


@pytest.mark.parametrize("pkg", ["intool_rag_tpu", "intool_rag_tpu_torch"])
def test_info_lines_reach_stderr_by_default_in_the_jax_format(pkg):
    err = _stderr(pkg, None)
    assert f" - {pkg}.tasks - INFO - probe line at info" in err
    assert f" - {pkg}.tasks - WARNING - probe line at warning" in err


@pytest.mark.parametrize("pkg", ["intool_rag_tpu", "intool_rag_tpu_torch"])
def test_log_level_warning_silences_info(pkg):
    err = _stderr(pkg, "WARNING")
    assert "probe line at info" not in err
    assert f"{pkg}.tasks - WARNING - probe line at warning" in err


def test_both_packages_format_a_line_alike():
    lines = [next(ln for ln in _stderr(pkg, None).splitlines() if "probe line at info" in ln)
             for pkg in ("intool_rag_tpu", "intool_rag_tpu_torch")]
    # "<asctime> - <name> - <level> - <message>": equal once the time and the package name are set aside
    assert [ln.split(" - ", 1)[1].replace("_torch", "") for ln in lines] == ["intool_rag_tpu.tasks - INFO - probe "
                                                                             "line at info"] * 2
