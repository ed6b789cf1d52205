"""Models of the port (NHWC in, NHWC out)."""
