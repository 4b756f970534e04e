#!/usr/bin/env python
"""Execute the reference's SQLLogicTest suite against this engine.

    python tools/run_reference_tests.py [/path/to/reference/test/sql]

Prints per-file block counts and exits non-zero on any failure."""

import glob
import os
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main(root: str) -> int:
    # Conformance golden values are platform-independent; default to the
    # CPU backend.  DFX_REFTEST_DEVICE=1 runs on the default backend.
    if os.environ.get("DFX_REFTEST_DEVICE") != "1":
        import jax

        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:  # noqa: BLE001 — backend already initialised
            pass

    from duckdb_faiss_ext_tpu.sql.logictest import run_file

    files = sorted(glob.glob(os.path.join(root, "*.test")))
    if not files:
        print(f"no .test files found under {root}", file=sys.stderr)
        return 2
    total = passed = 0
    rc = 0
    for path in files:
        try:
            results = run_file(path, root)
        except Exception as e:  # noqa: BLE001 — per-file isolation
            print(f"FAIL {os.path.basename(path)}: runner error: "
                  f"{type(e).__name__}: {e}")
            rc = 1
            continue
        fails = [(line, kind, f) for line, kind, f in results if f]
        total += len(results)
        passed += len(results) - len(fails)
        print(("PASS" if not fails else "FAIL"),
              f"{os.path.basename(path)}: "
              f"{len(results) - len(fails)}/{len(results)}")
        for line, kind, f in fails:
            print(f"   line {line} {kind}: {f}")
            rc = 1
    print(f"TOTAL {passed}/{total}")
    return rc


if __name__ == "__main__":
    root = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/test/sql"
    sys.exit(main(root))
