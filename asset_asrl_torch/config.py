"""Device and dtype of the PyTorch port.

The interior-point solver needs f64 bookkeeping, and the H100 has native
FP64, so every tensor the port creates names `DTYPE` (float64) and
`DEVICE` explicitly.  Torch defaults to float32 and to the CPU; nothing in
the port relies on `torch.set_default_dtype` or on a default device.

`DEVICE` is CUDA when a card is visible and the CPU otherwise, unless the
caller asks for a device with `use_device("cpu")` before building a
problem.  Modules read `config.DEVICE` when they build their tensors
(constants, index tables) and keep it, so a whole problem lives on one
device.
"""

import torch

DTYPE = torch.float64
INDEX_DTYPE = torch.int64
DEVICE = torch.device("cuda" if torch.cuda.is_available() else "cpu")


def use_device(device):
    """Make `device` ("cpu", "cuda", "cuda:1", a torch.device) the one
    that problems built from now on live on.  Returns it."""
    global DEVICE
    DEVICE = torch.device(device)
    return DEVICE


def tensor(v, device=None):
    """float64 tensor of `v` (numbers, numpy arrays, tensors) on `device`
    (default: `DEVICE`)."""
    return torch.as_tensor(v, dtype=DTYPE,
                           device=DEVICE if device is None else device)


def index(v, device=None):
    """int64 index tensor of `v` on `device` (default: `DEVICE`)."""
    return torch.as_tensor(v, dtype=INDEX_DTYPE,
                           device=DEVICE if device is None else device)
