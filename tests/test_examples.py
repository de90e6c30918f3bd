"""Smoke-run every checked-in example as a subprocess.

Examples are user-facing documentation (reference ships runnable
examples under examples/ and cmd/ too); an API change that breaks one
must fail CI, not a user. Regression: the join select= form changed to
flat output names and analytics_demo.py kept the old per-side pair for
three rounds because nothing executed it.
"""

import os
import pathlib
import subprocess
import sys

import pytest

EXAMPLES = sorted(
    (pathlib.Path(__file__).resolve().parent.parent / "examples").glob("*.py")
)


@pytest.mark.slow
@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_runs(path):
    env = dict(os.environ)
    # same CPU virtual mesh as conftest, but for the child process
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags = (flags + " --xla_force_host_platform_device_count=8").strip()
    env["XLA_FLAGS"] = flags
    proc = subprocess.run(
        [sys.executable, str(path)],
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, (
        f"{path.name} exited {proc.returncode}\n"
        f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-2000:]}"
    )
