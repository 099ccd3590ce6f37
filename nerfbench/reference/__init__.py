"""nerfbench's reference (see ../README.md)."""
