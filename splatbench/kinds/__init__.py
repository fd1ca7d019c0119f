"""The runners of the traffic kinds, one module each, found by the
``kind`` of a traffic file: ``kinds/<kind>.py`` with its ``run``."""
