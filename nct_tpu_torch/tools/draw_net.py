"""Net topology renderer: prototxt -> Graphviz DOT or a text table (port
of ``tools/draw_net.py``).

Rebuilds the reference's net-drawing tool (code/python/draw_net.py +
code/python/caffe/draw.py:130-244 ``get_pydot_graph`` /
``draw_net_to_file``) without pydot or graphviz: the DOT source is written
directly (render it with ``dot -Tpng``), and ``--format text`` prints the
layers in the order ``Net.forward`` runs them.

    python -m nct_tpu_torch.tools.draw_net deploy.prototxt net.dot \\
        [--rankdir LR]
    python -m nct_tpu_torch.tools.draw_net deploy.prototxt - \\
        --format text [--phase TRAIN]

It reads only the layer graph of the port's ``Net``, built with an
explicit ``device="cpu"``: the net computes nothing and allocates no
parameter here.  The output is byte-identical to the JAX tool's.
"""

from __future__ import annotations

import argparse
import sys

from nct_tpu_torch.nn.net import Net


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _hw(p: dict, field: str, base: str, default=None) -> str:
    """Render a possibly-repeated / possibly-h+w spatial hyper-param the way
    Caffe means it: ``base`` (e.g. kernel_size) may repeat per spatial dim,
    and <field>_h/<field>_w override it for rectangular shapes (caffe.proto
    ConvolutionParameter)."""
    h, w = p.get(f"{field}_h"), p.get(f"{field}_w")
    if h is not None or w is not None:
        return f"{h if h is not None else '?'}x{w if w is not None else '?'}"
    vals = _as_list(p.get(base))
    if not vals:
        return "" if default is None else str(default)
    return "x".join(str(v) for v in vals)


def _layer_detail(cfg: dict) -> str:
    """One-line hyper-parameter note for conv/pool/ip layers (the fields the
    reference surfaces in its node labels, draw.py:46-114)."""
    for key in ("convolution_param", "pooling_param"):
        p = cfg.get(key)
        if isinstance(p, dict):
            k = _hw(p, "kernel", "kernel_size", "?") or "?"
            s = _hw(p, "stride", "stride", 1) or "1"
            pad = _hw(p, "pad", "pad", 0) or "0"
            parts = [f"k{k}", f"s{s}", f"p{pad}"]
            if "num_output" in p:
                parts.insert(0, f"n{p['num_output']}")
            if key == "pooling_param":
                parts.insert(0, str(p.get("pool", "MAX")))
            return " ".join(parts)
    p = cfg.get("inner_product_param")
    if isinstance(p, dict) and "num_output" in p:
        return f"n{p['num_output']}"
    return ""


def _q(s: str) -> str:
    """Escape a string for use inside a double-quoted DOT identifier/label."""
    return str(s).replace("\\", "\\\\").replace('"', '\\"')


# node fill colors by role (original palette; the reference also colors by
# layer type, draw.py:117-127)
_COLORS = {
    "Convolution": "#cde6ff",
    "InnerProduct": "#cde6ff",
    "Pooling": "#ffe4c4",
    "ReLU": "#e6ffe6",
    "Input": "#f0f0f0",
}


def to_dot(net: Net, rankdir: str = "LR") -> str:
    """DOT digraph: box nodes per layer, ellipse nodes per blob."""
    lines = [
        f'digraph "{_q(net.name)}" {{',
        f"  rankdir={rankdir};",
        '  node [fontsize=10, fontname="Helvetica"];',
    ]
    # current[blob name] -> node id of its LATEST producer value: in-place
    # layers (Caffe ReLU, top == bottom) rebind the blob, and downstream
    # consumers must read the post-layer value, exactly as Net.forward's
    # dict rebind does
    current: dict[str, str] = {}
    emitted = set()

    def blob_node(node: str, label: str):
        # label may contain intentional DOT \n separators; its text parts
        # are pre-escaped by the callers
        if node not in emitted:
            emitted.add(node)
            lines.append(
                f'  "blob_{_q(node)}" [label="{label}", shape=ellipse];'
            )

    for name in net.inputs:
        current[name] = name
        shape = net.input_shapes.get(name)
        label = _q(name) if not shape else (
            _q(name) + "\\n" + "x".join(str(d) for d in shape)
        )
        blob_node(name, label)
    for cfg in net.layers:
        name = str(cfg.get("name", "?"))
        ltype = str(cfg.get("type", "?"))
        detail = _layer_detail(cfg)
        label = f"{_q(name)}\\n({_q(ltype)})" + (
            f"\\n{_q(detail)}" if detail else ""
        )
        fill = _COLORS.get(ltype, "#ffffff")
        lines.append(
            f'  "layer_{_q(name)}" [label="{label}", shape=box, '
            f'style=filled, fillcolor="{fill}"];'
        )
        bottoms = [str(b) for b in _as_list(cfg.get("bottom"))]
        tops = [str(t) for t in _as_list(cfg.get("top"))]
        for b in bottoms:
            src = current.get(b, b)
            blob_node(src, _q(b))
            lines.append(f'  "blob_{_q(src)}" -> "layer_{_q(name)}";')
        for t in tops:
            node = t if t not in bottoms else f"{t}@{name}"
            current[t] = node
            blob_node(node, _q(t))
            lines.append(f'  "layer_{_q(name)}" -> "blob_{_q(node)}";')
    lines.append("}")
    return "\n".join(lines) + "\n"


def to_text(net: Net) -> str:
    """Topologically ordered layer table (execution order of Net.forward)."""
    rows = [("LAYER", "TYPE", "BOTTOM -> TOP", "PARAMS")]
    for cfg in net.layers:
        bottoms = ",".join(str(b) for b in _as_list(cfg.get("bottom")))
        tops = ",".join(str(t) for t in _as_list(cfg.get("top")))
        rows.append((
            str(cfg.get("name", "?")), str(cfg.get("type", "?")),
            f"{bottoms or '-'} -> {tops or '-'}", _layer_detail(cfg) or "-",
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    return "\n".join(
        "  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows
    ) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("prototxt")
    ap.add_argument("output", help="output path, or - for stdout")
    ap.add_argument("--rankdir", default="LR", choices=["LR", "TB", "BT", "RL"])
    ap.add_argument("--format", default="dot", choices=["dot", "text"])
    ap.add_argument("--phase", default="TEST", choices=["TEST", "TRAIN"])
    args = ap.parse_args(argv)

    net = Net(args.prototxt, phase=args.phase, device="cpu")
    out = to_text(net) if args.format == "text" else to_dot(net, args.rankdir)
    if args.output == "-":
        sys.stdout.write(out)
    else:
        with open(args.output, "w") as f:
            f.write(out)
        print(f"wrote {args.output} ({len(out)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
