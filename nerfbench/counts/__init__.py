"""The yardstick's arithmetic: the H100's published peaks, the least work
of a grid call, and the model FLOPs of an iteration or a frame, from the
configuration and the traffic alone."""
