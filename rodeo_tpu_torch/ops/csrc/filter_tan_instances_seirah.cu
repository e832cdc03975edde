// The instances of K11a (filter_batch_tan.cuh) for SEIRAH at q = 3, under
// kramer and rodeo.
#include "filter_batch_tan.cuh"

namespace rodeo {

template struct FilterBatchTanInstances<Seirah, 3>;

}  // namespace rodeo
