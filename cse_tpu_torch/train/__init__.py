"""Training of the port: learning-rate schedules, the optimizer and the train step."""
