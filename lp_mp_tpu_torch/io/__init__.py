"""Input formats of the port: UAI."""
