"""Training runtime: the optimizer and its schedules, the captured steps."""
