#!/usr/bin/env python
"""Node-type census of .blob scene files (analog of the reference's
data/scripts/blobtreestats.py, modernized): per-file and aggregate
primitive/operator histograms, instance expansion factors.

Usage: python tools/blobtreestats.py [blob_dir]
"""
from __future__ import annotations

import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv: list[str]) -> int:
    from fembrain.assets import MODELS_DIR
    from fembrain.blob.reader import load_blob
    from fembrain.blob.types import OpType, PrimType

    blob_dir = Path(argv[1]) if len(argv) > 1 else MODELS_DIR / "blobtree"
    prim_total: Counter = Counter()
    op_total: Counter = Counter()
    rows = []
    for path in sorted(blob_dir.glob("*.blob")):
        try:
            sc = load_blob(path)
        except Exception as e:  # noqa: BLE001 - census should not abort
            rows.append((path.stem, f"PARSE ERROR: {e}"))
            continue
        n_before = len(sc.prims)
        sc.flatten_instances()
        prims = Counter(PrimType(p.ptype).name for p in sc.prims)
        ops = Counter(OpType(o.otype).name for o in sc.ops)
        prim_total.update(prims)
        op_total.update(ops)
        expand = f" (expanded {n_before}->{len(sc.prims)})" \
            if len(sc.prims) != n_before else ""
        rows.append(
            (path.stem,
             f"{len(sc.prims):4d} prims {len(sc.ops):3d} ops{expand}  "
             + " ".join(f"{k}:{v}" for k, v in sorted(prims.items()))
             + ("  | " + " ".join(f"{k}:{v}" for k, v in sorted(ops.items()))
                if ops else ""))
        )

    width = max(len(r[0]) for r in rows)
    for name, desc in rows:
        print(f"{name:<{width}}  {desc}")
    print("\n== aggregate ==")
    print("prims:", dict(sorted(prim_total.items())))
    print("ops:  ", dict(sorted(op_total.items())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
