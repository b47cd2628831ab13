"""Mamba2 chunked SSD scan for prefill: the CUDA kernel `ssd_scan.cu`,
its wrapper `ops.ssd` and its plain version `ref.ssd_scan_ref` (the
sequential recurrence)."""
