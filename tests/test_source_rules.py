"""Source rules: no module reaches TPU-only Pallas, and none chooses the
Pallas interpreter from the platform it runs on (only tests ask for
interpret mode)."""

import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sources():
    files = [os.path.join(ROOT, "bench.py"), os.path.join(ROOT,
                                                          "chip_smoke.py")]
    for base in ("duckdb_faiss_ext_tpu", "tools"):
        for dirpath, _, names in os.walk(os.path.join(ROOT, base)):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith(".py")]
    return files


@pytest.mark.parametrize("rule,pattern", [
    ("tpu pallas import", r"pallas[. ]+(import\s+)?tpu\b"),
    ("tpu pallas alias", r"\bpltpu\b"),
    ("platform probe", r"\bon_tpu\b"),
    ("interpret from the platform",
     r"interpret\s*=\s*(not\s+)?[\w.]*\(?[^,)]*(platform|backend|devices)"),
    ("interpret switched on outside tests", r"interpret\s*=\s*True"),
])
def test_no_module_breaks_rule(rule, pattern):
    hits = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            for no, line in enumerate(f, 1):
                if re.search(pattern, line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{no}: "
                                f"{line.strip()}")
    assert not hits, f"{rule}:\n" + "\n".join(hits)
