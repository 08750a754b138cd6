"""Traffic drivers, one a traffic kind; a mix's JSON names its kind."""
