"""Host utilities of the port: metric logging."""
