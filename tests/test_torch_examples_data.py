"""The expected report lines of the reference's examples at their
defaults (`tests/data/examples_expected.json`), against which
`chip_smoke.py`'s `[examples]` phase holds the port's `examples_torch/`
scripts on the card.

The lines are host numpy (the event engine and one core manager), so they
are the same on any machine. This file makes them from the reference's
`examples/` scripts in a child interpreter (`torch_harness`), and its test
checks that the committed file is current. Rewrite the file with

  PYTHONPATH=src python tests/test_torch_examples_data.py --write

What the file holds, by script: the arguments (`<DIR>` stands for a
temporary telemetry directory, the same for `carbon_report` and
`telemetry_report`, and `<EXPORT>` for the proposed run's export in it)
and the report lines: the whole output of
`quickstart`, `carbon_report` and `telemetry_report` (the lines matching
a regular expression of "drop", the runner's wall times, left out), and
the last lines of `serve_cluster`, the two cluster sweeps (its serving
demo prints times and depends on the device). In the lines, the
directory is written `<DIR>` and each run's fingerprint `<FP>`: the
fingerprint covers the export directory (in both packages).
"""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

from torch_harness import run_reference

REPO = Path(__file__).resolve().parents[1]
EXPECTED = REPO / "tests" / "data" / "examples_expected.json"
DIR, EXPORT = "<DIR>", "<EXPORT>"
#: a run's export directory, named by policy and fingerprint
FINGERPRINT = (r"\b(linux|least-aged|proposed)-[0-9a-f]{12}\b", r"\1-<FP>")
#: the runner's phase wall times and event rate (telemetry_report)
DROP = (r"^  [a-z_]+ +[0-9.]+ s$", r"^event loop: ")

_CHILD = r'''
import contextlib, glob, io, os, runpy, tempfile


def run(path, argv, name="__main__", then=()):
    sys.argv = [path, *argv]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(path, run_name=name)
        for fn in then:
            g[fn]()
    return buf.getvalue()


tel = tempfile.mkdtemp()
out = {"dir": tel,
       "quickstart": run("examples/quickstart.py", []),
       "carbon_report": run("examples/carbon_report.py", ["--telemetry",
                                                          tel])}
export = glob.glob(os.path.join(tel, "proposed-*"))[0]
out["telemetry_report"] = run("examples/telemetry_report.py", [export])
out["serve_cluster"] = run("examples/serve_cluster.py", [], name="examples",
                           then=("cluster_demo", "routing_demo"))
json.dump(out, sys.stdout)
'''


def report_lines(stdout: str, directory: str | None = None,
                 drop=DROP) -> list[str]:
    """`stdout`'s lines with `directory` written as `<DIR>`, fingerprints
    as `<FP>`, and the lines matching a pattern of `drop` left out."""
    if directory:
        stdout = stdout.replace(directory, DIR)
    stdout = re.sub(*FINGERPRINT, stdout)
    return [ln for ln in stdout.splitlines()
            if not any(re.search(p, ln) for p in drop)]


def expected_lines() -> dict:
    """The file's content, made from the reference's examples."""
    out = run_reference(_CHILD, {}, timeout=900)
    tel = out["dir"]
    sweeps = report_lines(out["serve_cluster"])
    first = sweeps.index("=== cluster simulation (22 machines, policy x "
                         "scenario) ===")
    return {
        "drop": list(DROP), "fingerprint": list(FINGERPRINT),
        "scripts": {
            "quickstart": {"args": [],
                           "lines": report_lines(out["quickstart"])},
            "carbon_report": {
                "args": ["--telemetry", DIR],
                "lines": report_lines(out["carbon_report"], tel)},
            "telemetry_report": {
                "args": [EXPORT],
                "lines": report_lines(out["telemetry_report"], tel)},
            "serve_cluster": {"args": [], "tail": True,
                              "lines": sweeps[first:]},
        },
    }


def test_expected_lines_are_current():
    """The committed lines equal the reference's examples' own, made now
    (about a minute: the reference's quickstart, its carbon report at the
    defaults with every telemetry export, and its two cluster sweeps)."""
    assert json.loads(EXPECTED.read_text()) == expected_lines()


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(f"usage: {sys.argv[0]} --write")
    EXPECTED.parent.mkdir(exist_ok=True)
    EXPECTED.write_text(json.dumps(expected_lines(), indent=1) + "\n")
    print(f"wrote {EXPECTED}")
