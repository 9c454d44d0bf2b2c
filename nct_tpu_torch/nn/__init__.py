"""Config-driven NN graph framework (the Caffe ``Net``/``Layer`` analogue;
port of ``nct_tpu/nn``).

A prototxt-driven DAG of registered layer ops over NCHW tensors, run on
the card (or on the CPU when asked), with weights loaded straight from
.caffemodel files via the wire-format reader in
``nct_tpu_torch.models.caffe_io``.  The inference half: forward passes
only.
"""

from nct_tpu_torch.nn.layers import LAYER_REGISTRY, register_layer  # noqa: F401
from nct_tpu_torch.nn import losses  # noqa: F401  (registers loss/data layers)
from nct_tpu_torch.nn import recurrent  # noqa: F401  (registers RNN/LSTM)
from nct_tpu_torch.nn import vision  # noqa: F401  (registers ROI/PSROI pooling)
from nct_tpu_torch.nn.net import Net  # noqa: F401
from nct_tpu_torch.nn.net_spec import L, NetSpec, emit_prototxt  # noqa: F401
from nct_tpu_torch.nn.prototxt import parse_prototxt  # noqa: F401
