#!/usr/bin/env python3
"""Runs the `chip_smoke.py` of a tree and logs the SAM each of its phases
builds, to hold two trees' mapping output to each other on one CUDA
device.

    python3 scripts/smoke_digests.py TREE > TREE.log

TREE is a checkout (for example an earlier commit unpacked with
`git archive` under the ignored `build/`); its `chip_smoke.py` runs as
it would alone, and every list of SAM lines its phases build through
`_sam_lines` is printed as `DIGEST <n> <lines> <sha256>` in build order.
Two logs compare with

    comm -3 <(awk '/^DIGEST/ {print $3, $4}' A.log | sort -u) \\
            <(awk '/^DIGEST/ {print $3, $4}' B.log | sort -u)

which prints the digests only one tree built.
"""

import hashlib
import os
import sys


def main() -> int:
    if len(sys.argv) != 2:
        sys.stderr.write(__doc__)
        return 2
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    os.chdir(tree)
    sys.argv = [os.path.join(tree, "chip_smoke.py")]
    import chip_smoke

    orig = chip_smoke._sam_lines
    calls = [0]

    def logged(mapper, results):
        lines = orig(mapper, results)
        calls[0] += 1
        digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()
        print(f"DIGEST {calls[0]} {len(lines)} {digest}", flush=True)
        return lines

    chip_smoke._sam_lines = logged
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
