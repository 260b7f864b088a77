"""Step functions: the train step, and the serving steps the servers call."""
