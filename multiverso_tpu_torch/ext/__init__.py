"""Binding-extension layer: shared variables, model param managers, callbacks
(port of ``multiverso_tpu/ext``).

The sync contract is the reference's (``theano_ext/sharedvar.py:34-49``): a
shared value keeps a snapshot of the last value pulled from the table;
``sync()`` pushes ``current - snapshot`` (the local work since the last
sync) and pulls the merged global value back.

:class:`PytreeParamManager` keeps the JAX package's name: here it manages a
nested dict or list of tensors, for example a module's
``dict(named_parameters())``.
"""

from multiverso_tpu_torch.ext.sharedvar import (SharedArray, mv_shared,
                                                shared_vars,
                                                sync_all_shared_vars)
from multiverso_tpu_torch.ext.param_manager import (ParamManager,
                                                    PytreeParamManager,
                                                    TorchParamManager)
from multiverso_tpu_torch.ext.callbacks import MVCallback

__all__ = [
    "SharedArray", "mv_shared", "shared_vars", "sync_all_shared_vars",
    "ParamManager", "PytreeParamManager", "TorchParamManager",
    "MVCallback",
]
