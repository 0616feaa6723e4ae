from repro_torch.baselines.numpy_reference import run_fednl_numpy_reference

__all__ = ["run_fednl_numpy_reference"]
