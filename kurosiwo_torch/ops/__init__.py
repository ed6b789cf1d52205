"""Operations of the port: kernels' wrappers and plain tensor code."""
