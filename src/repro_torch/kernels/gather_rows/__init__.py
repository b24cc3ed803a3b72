from repro_torch.kernels.gather_rows.ops import gather_rows, gather_rows_plain

__all__ = ["gather_rows", "gather_rows_plain"]
