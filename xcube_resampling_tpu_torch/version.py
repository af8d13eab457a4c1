version = "0.5.0"
