"""Run-directory I/O (port of terastructure_tpu/io): the text model and
the checkpoint."""

from terastructure_tpu_torch.io.checkpoint import (  # noqa: F401
    restore_checkpoint, save_checkpoint, wait_until_finished)
from terastructure_tpu_torch.io.export import (  # noqa: F401
    load_matrix, load_model, save_model, state_from_text_model)
