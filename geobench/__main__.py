import sys

from geobench.run import main

sys.exit(main())
