"""Reference-checkpoint compatibility layer.

Imports PyTorch ``state_dict`` checkpoints saved by the reference trainer
(``version5_model_train.py:509-515``: raw ``generator.state_dict()`` /
``discriminator.state_dict()`` files) into the port's models, so a user
migrating from the reference keeps their trained weights (the port's copy
of ``a2m/compat``).
"""

from a2m_torch.compat.torch_import import (ImportReport, import_discriminator,
                                           import_generator,
                                           load_torch_generator)

__all__ = ['ImportReport', 'import_discriminator', 'import_generator',
           'load_torch_generator']
