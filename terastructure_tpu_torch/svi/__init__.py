from terastructure_tpu_torch.svi.driver import FitResult, fit  # noqa: F401
