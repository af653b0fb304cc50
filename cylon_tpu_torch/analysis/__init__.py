"""Plan analysis: the capture hook the planner and the recorder share."""
