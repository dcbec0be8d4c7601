"""Operations and bytes of the port's kernels, counted from shapes."""
