"""CLI: ``python -m repro_torch.analysis [paths ...]`` (default path
``src/repro_torch``, the port).

Exit status is the CI contract: 0 = clean tree, 1 = at least one
unsuppressed finding, 2 = usage error, as ``python -m repro.analysis``'s.
``--format json`` emits a findings artifact.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import ALL_CHECKERS, analyze, find_repo_root, load_project
from repro_torch.analysis.checkers.schema import SCHEMA_REL, extract_schema


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static-analysis suite (RPA001-RPA005)",
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to scan (default: src/repro_torch)")
    ap.add_argument(
        "--select",
        default=None,
        help="comma-separated checker codes to run (e.g. RPA001,RPA004); default all",
    )
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument(
        "--list", action="store_true", help="list checker codes and exit"
    )
    ap.add_argument(
        "--write-schema",
        action="store_true",
        help=f"regenerate {SCHEMA_REL} from the current tree and exit "
        "(the deliberate metrics-contract update step)",
    )
    args = ap.parse_args(argv)

    if args.list:
        for cls in ALL_CHECKERS:
            print(f"{cls.code}  {cls.description}")
        return 0

    paths = args.paths or ["src/repro_torch"]
    for p in paths:
        if not Path(p).exists():
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    if args.write_schema:
        root = find_repo_root(Path(paths[0]))
        project = load_project([Path(p) for p in paths], root=root)
        out = root / SCHEMA_REL
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(extract_schema(project), indent=2) + "\n", encoding="utf-8")
        print(f"wrote {out}")
        return 0

    select = None if args.select is None else [c.strip() for c in args.select.split(",") if c.strip()]
    findings = analyze(paths, select=select)

    if args.format == "json":
        print(json.dumps(dict(count=len(findings), findings=[f.as_dict() for f in findings]), indent=2))
    else:
        for f in findings:
            print(f)
        n = len(findings)
        print(f"repro_torch.analysis: {n} finding{'s' if n != 1 else ''}" if n else "repro_torch.analysis: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
