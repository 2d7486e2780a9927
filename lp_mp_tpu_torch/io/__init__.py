"""Input formats of the port: UAI and the Torresani graph matching format."""
