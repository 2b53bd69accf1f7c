# Serving session core (counterpart of repro.launch.session).
