"""Traffic drivers (``<driver>.py``) and traffic mixes (``<mix>.json``,
each naming its driver and holding its parameters)."""
