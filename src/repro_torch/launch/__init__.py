"""Launchers of the port: ``serve`` (the COAX-routed serving launcher) and
``train`` (only ``reduced`` until the training slice brings its ``main``)."""
