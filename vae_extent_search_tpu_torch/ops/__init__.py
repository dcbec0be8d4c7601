"""Device operations of the port: the fused-head kernel, k-center greedy."""
