"""Write a content file of the benchmark: a tar of an installed Python
standard library, compressed whole at level 19, and its description.

    python -m portbench.content.build --stdlib <prefix>/lib/python3.12 \\
        --name cpython-3.12.12-stdlib --source "<where the install comes from>"

The tar holds every regular file under ``--stdlib`` except
``site-packages/`` and ``__pycache__/``, in sorted path order, under
``python3.12/``, with mode 0644, mtime 0 and owner root, so the same
install gives the same bytes.  ``<name>.json`` beside it records the
tar's size and SHA-256, which every run checks.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import pathlib
import tarfile

from .. import libzstd

HERE = pathlib.Path(__file__).resolve().parent
SKIP = ("site-packages", "__pycache__")


def stdlib_tar(root: str) -> bytes:
    names = []
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in SKIP]
        names += [os.path.relpath(os.path.join(d, f), root) for f in files
                  if os.path.isfile(os.path.join(d, f)) and not os.path.islink(os.path.join(d, f))]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.USTAR_FORMAT) as tar:
        for name in sorted(names):
            info = tarfile.TarInfo(f"{os.path.basename(root)}/{name}")
            info.size, info.mode, info.mtime = os.path.getsize(os.path.join(root, name)), 0o644, 0
            info.uname = info.gname = "root"
            with open(os.path.join(root, name), "rb") as f:
                tar.addfile(info, f)
    return buf.getvalue()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stdlib", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--source", required=True)
    args = ap.parse_args(argv)
    raw = stdlib_tar(args.stdlib)
    (HERE / f"{args.name}.tar.zst").write_bytes(libzstd.compress(raw, 19, checksum=True))
    desc = {"source": args.source, "bytes": len(raw), "sha256": hashlib.sha256(raw).hexdigest()}
    (HERE / f"{args.name}.json").write_text(json.dumps(desc, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
