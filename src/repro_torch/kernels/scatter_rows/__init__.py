from repro_torch.kernels.scatter_rows.ops import scatter_rows, scatter_rows_plain

__all__ = ["scatter_rows", "scatter_rows_plain"]
