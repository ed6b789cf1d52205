"""Train state and steps of the port."""
