"""Op surface of the port: each kernel's wrapper beside its plain version."""
