"""Upgrade legacy prototxt definitions to the modern format (port of
``tools/upgrade_proto.py``; reference: tools/upgrade_net_proto_text.cpp
and upgrade_solver_proto_text.cpp).

    python -m nct_tpu_torch.tools.upgrade_proto net INPUT OUTPUT \\
        [--convert-inputs]
    python -m nct_tpu_torch.tools.upgrade_proto solver INPUT OUTPUT

Parses the input, runs the upgrade chain (``nn.upgrade``: V0 nested
layers -> V1 ``layers`` with enums -> V2, the data transform split, with
``--convert-inputs`` the net's ``input:`` fields into an Input layer, and
the solver_type enum -> the type string) and writes prototxt text through
``nn.net_spec.emit_prototxt``, byte-identical to the JAX tool's.  A host
tool: nothing goes to a device.
"""

from __future__ import annotations

import argparse

from nct_tpu_torch.nn.net_spec import emit_prototxt
from nct_tpu_torch.nn.prototxt import load_prototxt
from nct_tpu_torch.nn.upgrade import upgrade_net, upgrade_solver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("kind", choices=("net", "solver"))
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--convert-inputs", action="store_true",
                    help="also convert net `input:` fields into an Input "
                         "layer (UpgradeNetInput)")
    args = ap.parse_args(argv)
    msg = load_prototxt(args.input)
    if args.kind == "net":
        out = upgrade_net(msg, convert_inputs=args.convert_inputs)
    else:
        out = upgrade_solver(msg)
    text = emit_prototxt(out)
    with open(args.output, "w") as f:
        f.write(text)
    print(f"wrote {args.output} ({len(text)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
