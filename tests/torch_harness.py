"""Runs reference code of `repro` in a child interpreter, for the port's
parity tests (`tests/test_torch_*.py`).

The reference's simulator, core manager and serving engine do not import
on Python 3.12 (ROADMAP R1: `IdleCorrection` has ndarray dataclass
defaults). The child installs a shim, in itself only, that turns such
defaults into default factories before it imports `repro`; nothing of
`repro.core`, `repro.sim` or `repro.serving` is imported into the pytest
process. A job goes to the child as JSON on its stdin, and the child
answers with JSON on its stdout.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

#: prepended to every child script: the R1 shim, then `job` read from stdin
PRELUDE = r'''
import dataclasses, json, sys
import numpy as np

# R1 shim: turn ndarray dataclass defaults into default factories.
_orig = dataclasses._get_field
def _get_field(cls, a_name, a_type, default_kw_only):
    default = cls.__dict__.get(a_name, dataclasses.MISSING)
    if isinstance(default, np.ndarray):
        setattr(cls, a_name, dataclasses.field(default_factory=default.copy))
    return _orig(cls, a_name, a_type, default_kw_only)
dataclasses._get_field = _get_field

job = json.load(sys.stdin)
'''


def run_reference(script: str, job, timeout: float = 600):
    """Run `script` (after `PRELUDE`, with `job` bound) on the reference
    in a child interpreter on the CPU; returns what it wrote to stdout,
    parsed as JSON."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", PRELUDE + script],
                          input=json.dumps(job), capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout)
