"""Plain references of the port's searches, outside both packages: they
import only torch and numpy, and run on the CPU and on the card alike."""
