from terastructure_tpu_torch.models import psd  # noqa: F401
