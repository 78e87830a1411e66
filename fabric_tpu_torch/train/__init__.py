"""Training: optimizer and schedule, steps, preemption, the loop."""
