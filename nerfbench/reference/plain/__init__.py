"""The plain float32 reference: a frozen copy of the port's plain path
(fields, MLPs, the brick and hash grids, proposal sampling, compositing,
losses and Adam), which imports nothing of the port."""
