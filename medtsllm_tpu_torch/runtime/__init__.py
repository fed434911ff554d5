"""Training runtime: the optimizer and its schedules."""
