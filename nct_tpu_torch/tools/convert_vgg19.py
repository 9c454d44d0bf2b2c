"""Convert VGG_ILSVRC_19_layers.caffemodel to the npz that
``nct_tpu_torch.models.vgg19.load_params`` (and the CLI's ``-m``) reads.

    python -m nct_tpu_torch.tools.convert_vgg19 <model.caffemodel> <out.npz>

Replaces the reference's runtime protobuf weight loading (net.cpp:760-824)
with a one-time offline conversion (``models.caffe_io``).
"""

from __future__ import annotations

import sys

from nct_tpu_torch.models.caffe_io import caffemodel_to_npz


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__)
        return 1
    converted = caffemodel_to_npz(args[0], args[1])
    print(f"converted {len(converted)} layers: {', '.join(converted)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
