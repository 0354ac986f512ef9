"""Configuration, logging and profiling helpers of the port."""
