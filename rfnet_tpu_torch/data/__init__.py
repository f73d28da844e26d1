"""Host data: the .pcd codec and the resampling / synthetic-pair helpers."""
