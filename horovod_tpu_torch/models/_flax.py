"""flax variables (as numpy arrays) to a torch ``state_dict``, for modules
whose submodule names mirror flax's.

Each flax module with a ``kernel`` becomes ``<path>.weight`` (a conv kernel
HWIO → OIHW, a dense kernel (in, out) → (out, in)) and ``<path>.bias``; a
BatchNorm's ``scale``/``bias`` become ``weight``/``bias`` and its
``batch_stats`` ``mean``/``var`` the running statistics (flax's biased
variance, as the port's BatchNorm keeps it), with ``num_batches_tracked``
0.
"""

import numpy as np
import torch


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def state_dict_from_flax(variables):
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {}

    def walk(p, s, prefix):
        for name, sub in p.items():
            key = prefix + name
            if "kernel" in sub:
                k = np.asarray(sub["kernel"], np.float32)
                k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
                sd[key + ".weight"] = torch.tensor(np.ascontiguousarray(k))
                if "bias" in sub:
                    sd[key + ".bias"] = _t(sub["bias"])
            elif "scale" in sub:
                sd[key + ".weight"] = _t(sub["scale"])
                sd[key + ".bias"] = _t(sub["bias"])
                sd[key + ".running_mean"] = _t(s[name]["mean"])
                sd[key + ".running_var"] = _t(s[name]["var"])
                sd[key + ".num_batches_tracked"] = torch.tensor(0)
            else:
                walk(sub, s.get(name, {}), key + ".")
    walk(params, stats, "")
    return sd
