"""The port's hand-written kernels and their wrappers: ``attention``
(the flash kernels) and ``conv`` (the 3×3 conv). Importing the package
defines their ``torch.library`` operators (``mxtpu_torch::flash_attn_fwd``,
``flash_attn_fwd_lse``, ``conv3x3``), which a saved ``torch.export``
archive needs before it loads (``contrib.deploy.load``)."""
from . import attention, conv  # noqa: F401
