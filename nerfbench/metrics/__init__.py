"""nerfbench's metrics (see ../README.md)."""
